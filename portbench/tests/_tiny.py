"""A cell cut to a size the CPU holds in seconds, for the tests."""

from portbench import run

# about 12% of the HVG matrix stored: the dense lane, whose arithmetic the
# reference mirrors operation for operation
TINY = dict(cells=1200, genes=3000, umi_scale=60.0, num_highvar_genes=300,
            components=[5, 7], n_iter=4, batch_size=600)
# about 4% stored: the ELL lane (the kernels' plain versions on the CPU)
ELL = dict(umi_scale=20.0, num_highvar_genes=1000)


def tiny_spec(cell: str, **over) -> dict:
    """The cell at the tiny size; its ``path`` names the lane that size
    takes (the dense lane unless the ELL override is given)."""
    spec = run.resolve(run.load_benchmark(), cell)
    cfg = spec["config"]
    cfg.update(TINY, **over)
    cfg["path"] = dict(cfg["path"], lane="ell" if over == ELL else "dense")
    return spec


def run_tiny(cell: str, seed: int = 5, trace: bool = False,
             per_k: int | None = None, **over) -> dict:
    """One run of the cell on the CPU at the tiny size, past the harness's
    look for a card; ``per_k`` replicates of each K compared (the mix's
    own by default)."""
    import time

    import torch

    torch.set_num_threads(2)
    spec = tiny_spec(cell, **over)
    if per_k is not None:
        spec["traffic"] = dict(spec["traffic"], sample_per_job_per_k=per_k)
    return run.run_cell(spec, seed, 0.01, trace, "cpu", time.time())
