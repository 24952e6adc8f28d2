"""ranks.allreduce_ms: rank 0's host time in each epoch's allreduce_sums,
with the card synchronised before and after, so that the wait for the
slowest rank counts, mean in ms."""


def read(ctx):
    if ctx.world < 2 or not ctx.allreduce:
        return None
    return 1e3 * sum(ctx.allreduce) / len(ctx.allreduce)
