"""suffstat.sparse_share: the rows that bsc_suffstat summed by pair (n <=
32 units on) over all the rows with a responsibility it summed in the
traced window (Σ suffstat.sparse_rows / Σ(suffstat.sparse_rows +
suffstat.dense_rows), the program's counters on the trainer's em_step
spans), in %.  A program that counts no such rows gives None (ES3C, a
program without the counters)."""

from portbench.programspans import counter


def read(ctx):
    sparse = counter(ctx, "suffstat.sparse_rows")
    dense = counter(ctx, "suffstat.dense_rows")
    if sparse is None or dense is None or sparse + dense == 0:
        return None
    return 100.0 * sparse / (sparse + dense)
