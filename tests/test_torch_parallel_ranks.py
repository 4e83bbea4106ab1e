"""The work of the data-parallel ranks of tests/test_torch_parallel.py (it
holds no test itself).

``run(cases, device)`` takes train steps of the port and returns what they
left. Called in a process with no process group it is the one-process step;
on the ranks of ``parallel.spawn`` each rank takes its rows of every global
batch and the step runs data-parallel. Kept apart from the test files so
that the spawned ranks import neither JAX nor pytest
(tests/test_torch_parallel.py on the CPU, tests/test_torch_cuda.py on the
card).
"""
import torch
import torch.distributed as dist

from speedplusbaseline_tpu_torch.augment.styleaug import StyleAugmentor
from speedplusbaseline_tpu_torch.config import default_cfg
from speedplusbaseline_tpu_torch.engine import TrainState, build_optimizer, dann_step, krn_step
from speedplusbaseline_tpu_torch.engine.steps import (make_dann_train_step, make_krn_train_step,
                                                      make_spn_train_step)
from speedplusbaseline_tpu_torch.models import get_model
from speedplusbaseline_tpu_torch.parallel import global_rows, rank_rows, rank_world


def _my_rows(n: int) -> slice:
    """This rank's rows of a global batch of ``n`` (all of them in one
    process)."""
    rw = rank_world()
    return slice(None) if rw is None else rank_rows(n, *rw)


def _rows(batch, device):
    return {k: torch.as_tensor(v)[_my_rows(len(v))].to(device) for k, v in batch.items()}


def _spread(model) -> float:
    """The largest difference between this rank's parameters and buffers
    and rank 0's, summed over the ranks (0 in one process)."""
    if rank_world() is None:
        return 0.0
    worst = torch.zeros((), dtype=torch.float64, device=next(model.parameters()).device)
    for t in model.state_dict().values():
        ref = t.clone()
        dist.broadcast(ref, 0)
        worst = torch.maximum(worst, (t - ref).abs().max().double())
    dist.all_reduce(worst)
    return float(worst)


class Restyle:
    """The style augmentor, recording the global batch it restyled
    (``natural``). With ``replay``, a global restyled batch, it returns that
    batch's rows in place of its own output. The generator's FiLM layers are
    f32 matmuls whose rounding depends on the number of rows they are given,
    so one rank's restyle of 4 rows and one process's of 8 differ in the
    last bits, which the float64 KRN step amplifies; replaying the ranks'
    restyle in one process holds the rest of the step to the ranks' bit for
    bit."""

    def __init__(self, aug, replay=None):
        self.aug, self.replay, self.natural = aug, replay, None

    def __call__(self, x, generator=None, z=None):
        self.natural = global_rows(self.aug(x, generator, z))
        out = self.natural if self.replay is None else torch.from_numpy(self.replay).to(x.device)
        return out[_my_rows(out.shape[0])]


def run_case(case, device):
    """One step of ``case`` on ``device``: a model built from
    ``case["seed"]`` or given as ``case["state"]``, in ``case["dtype"]``
    (float64 unless given)."""
    device = torch.device(device)
    cfg = default_cfg(**case["cfg"])
    torch.manual_seed(case.get("seed", 0))
    model = get_model(cfg)
    if "state" in case:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()})
    model = model.to(device, getattr(torch, case.get("dtype", "float64")),
                     memory_format=torch.channels_last)
    state = TrainState(model, build_optimizer(cfg, model.parameters()))
    kind, aug = case["kind"], None
    if kind in ("krn", "spn"):
        if case.get("style") is not None:
            stats, ghiasi = case["style"]
            gen = StyleAugmentor(cfg.texture_alpha, stats, device=device)
            gen.ghiasi.load_state_dict({k: torch.from_numpy(v) for k, v in ghiasi.items()})
            aug = Restyle(gen, case.get("replay"))
        make = make_krn_train_step if kind == "krn" else make_spn_train_step
        sm = make(cfg, device, aug)(state, _rows(case["batch"], device), aug is not None)
    elif kind == "dann":
        sm = make_dann_train_step(cfg, device)(state, _rows(case["source"], device),
                                               _rows(case["target"], device), case["alpha"])
    elif kind == "krn_draws":  # JAX's aug draws, given
        b, d = _rows(case["batch"], device), _rows(case["draws"], device)
        sm = krn_step(state, b["image"], b["keypts"], d, False)
    else:  # "dann_draws"
        s, t = _rows(case["source"], device), _rows(case["target"], device)
        sm = dann_step(state, s["image"], s["keypts"], _rows(case["src_draws"], device),
                       t["image"], _rows(case["tgt_draws"], device), case["alpha"], False)
    opt = state.optimizer.state_dict()["state"]
    return {"state": {k: v.cpu().numpy() for k, v in model.state_dict().items()},
            "opt": [{k: v.cpu().numpy() for k, v in opt[i].items()} for i in sorted(opt)],
            "losses": {k: float(v) for k, v in sm.items()},
            "styled": None if aug is None else aug.natural.cpu().numpy(),
            "spread": _spread(model)}


def run(cases, device="cpu"):
    # f32 is full f32, as in the CLIs (cuDNN would run f32 convs in TF32).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return [run_case(c, device) for c in cases]
