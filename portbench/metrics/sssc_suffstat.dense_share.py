"""sssc_suffstat.dense_share: the rows that the ES3C suffstat kernels solved
by a warp (n > SPARSE_N units on) over all the rows with a responsibility
they solved in the traced window (Σ sssc_suffstat.dense_rows /
Σ(sssc_suffstat.sparse_rows + sssc_suffstat.dense_rows), the program's
counters on the trainer's em_step spans), in %.  A program that counts no
such rows gives None (EBSC, the wide path, a program without the
counters)."""

from portbench.programspans import counter


def read(ctx):
    sparse = counter(ctx, "sssc_suffstat.sparse_rows")
    dense = counter(ctx, "sssc_suffstat.dense_rows")
    if sparse is None or dense is None or sparse + dense == 0:
        return None
    return 100.0 * dense / (sparse + dense)
