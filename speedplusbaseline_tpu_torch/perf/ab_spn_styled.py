"""A/B: the styled SPN step with the phase-space Ghiasi lowering at 228^2
against the plain lowering at 227^2 (the counterpart of the JAX package's
``scripts/ab_spn_styled.py``).

SPN's 227^2 input is odd: the phase-space lowering (``Ghiasi(phase_space=
True)``, the JAX module's ``tpu_opt``) reflect-pads it to 228^2 first, while
the plain lowering takes 227 as it is (its stride-2 convs round up, so both
emit 228^2). Arm ``phase`` restyles with the first, arm ``plain`` with the
second, on the styled SPN step (batch 48, bf16, AdamW, the config's
classes). Each arm runs in its own process with the root bench.py's timing
protocol (``common.timed_chain``):

    python -m speedplusbaseline_tpu_torch.perf.ab_spn_styled              # both arms
    python -m speedplusbaseline_tpu_torch.perf.ab_spn_styled --arm phase  # one arm

``--n`` sets the timed steps (150); ``--no_cuda`` runs on the CPU. The
Without ``--arm`` it prints ``{arm: {...}}`` last; an arm that fails raises.
"""
from __future__ import annotations

from typing import Optional, Sequence

from . import common

ARMS = ("phase", "plain")


def run_arm(arm: str, dev, **kw) -> dict:
    """One arm in this process; ``kw`` goes to ``common.styled_arm``."""
    return common.styled_arm(arm, "spn", dev, phase_space=arm == "phase", **kw)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return common.ab_main("ab_spn_styled", ARMS, run_arm, argv)


if __name__ == "__main__":
    main()
