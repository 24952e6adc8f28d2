"""merge.kernel_share: the blocks of the traced window whose unification
merge ran as one launch of the merge kernel (csrc/varykn_merge.cu), over
all the blocks the model step ran (Σ merge.kernel_blocks / Σ
em_step.blocks, the program's counters on the trainer's em_step spans), in
%.  A program that does not count the merge kernel's blocks gives None."""

from portbench.programspans import counter


def read(ctx):
    kernel = counter(ctx, "merge.kernel_blocks")
    blocks = counter(ctx, "em_step.blocks")
    if kernel is None or not blocks:
        return None
    return 100.0 * kernel / blocks
