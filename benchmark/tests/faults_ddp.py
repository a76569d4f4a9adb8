"""Faults planted in the data-parallel training cell's rank 0, for
`test_portbench_ddp.py`: each takes the driver and the run's context and
returns rank 0's part of the job with something broken underneath."""
from __future__ import annotations


def ddp_rank0_wrong_rows(driver, ctx):
    """Rank 0 feeds rank 1's rows of every batch in place of its own."""
    real = driver.train_pool

    def pool(traffic, *a):
        p = real(traffic, *a)
        rows = int(traffic["batch"]) // int(traffic["ranks"])
        p[:, :rows] = p[:, rows:2 * rows]
        return p

    driver.train_pool = pool
    return driver.setup(ctx)


def ddp_rank1_dies(driver, ctx):
    """Rank 1 is killed once the job is set up."""
    sv = driver.setup(ctx)
    sv.workers.procs[0].kill()
    return sv
