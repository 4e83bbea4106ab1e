"""A/B: the styled image stored in bf16 or in f32 (the counterpart of the JAX
package's ``scripts/ab_bf16_out.py``).

The generator's sigmoid output is stored in its compute dtype (bf16) by
default; ``Ghiasi(f32_out=True)`` stores the f32 sigmoid and leaves the cast
to the train step's bf16 forward. This times both on the styled KRN step
(224^2) and the styled SPN step (227^2), batch 48, bf16, AdamW, with the
port's default (plain) Ghiasi lowering, which each arm's line names. Each
arm runs in its own process with the root bench.py's timing protocol
(``common.timed_chain``):

    python -m speedplusbaseline_tpu_torch.perf.ab_bf16_out           # all four arms
    python -m speedplusbaseline_tpu_torch.perf.ab_bf16_out --arm krn_bf16   # one arm

``--n`` sets the timed steps (150); ``--no_cuda`` runs on the CPU. The
Without ``--arm`` it prints ``{arm: {...}}`` last; an arm that fails raises.
"""
from __future__ import annotations

from typing import Optional, Sequence

from . import common

ARMS = ("krn_bf16", "krn_f32", "spn_bf16", "spn_f32")


def run_arm(arm: str, dev, **kw) -> dict:
    """One arm in this process; ``kw`` goes to ``common.styled_arm``."""
    model_name, out_dtype = arm.split("_")
    return common.styled_arm(arm, model_name, dev, f32_out=out_dtype == "f32", **kw)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return common.ab_main("ab_bf16_out", ARMS, run_arm, argv)


if __name__ == "__main__":
    main()
