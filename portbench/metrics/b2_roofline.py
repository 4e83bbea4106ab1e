"""b2_roofline: kernel B2 (InstanceNorm + FiLM, ``ops/instancenorm.py``
-> ``csrc/instancenorm.cu``): the least time its six sites of a restyle
need (``work.b2_bytes``: x read once, y written once, gamma and beta read;
bound by bytes) over the time of its kernels, known by name: the cluster
path's one kernel, or the two-pass path's statistics, finalize and apply."""

from portbench import trace as tr
from portbench import work

OWN = ("in_cluster_kernel", "in_stats_kernel", "in_apply_kernel")
SITES = 6


def read(ctx):
    events = tr.chain(ctx.events, OWN, "in_finalize_kernel", "in_stats_kernel")
    calls = sum(1 for e in events if tr.ident(e.name) in ("in_cluster_kernel", "in_stats_kernel"))
    styled = sum(ctx.styled)
    if ctx.peak is None or not calls or calls != SITES * styled:
        return None
    elem = 2 if ctx.config["fp16"] else 4
    nbytes = sum(work.b2_bytes(ctx.batch, h, w, c, elem, film)
                 for h, w, c, film in work.generator_norm_sites(ctx.config["input_side"]))
    least = work.least_seconds(0.0, nbytes, ctx.peak)
    return 100.0 * styled * least / (sum(e.dur for e in events) * 1e-6)
