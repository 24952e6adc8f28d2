"""em_step.graph_share: the blocks of the traced window that the model step
ran as replays of captured CUDA graphs, over all the blocks it ran
(Σ em_step.graph_blocks / Σ em_step.blocks, the program's counters on the
trainer's em_step spans), in %.  A program that counts no blocks gives
None."""

from portbench.programspans import counter


def read(ctx):
    blocks = counter(ctx, "em_step.blocks")
    if not blocks:
        return None
    return 100.0 * (counter(ctx, "em_step.graph_blocks") or 0) / blocks
