"""The measuring modules: the port's counterparts of the JAX package's
``scripts/bench_e2e.py``, ``bench_host_loader.py``, ``ab_bf16_out.py`` and
``ab_spn_styled.py``, under the same names.

    common.py            -- the root bench.py's timing protocol
                            (WARMUP_STEPS, the chained-step timing), the
                            device from --no_cuda, the card line every JSON
                            line carries, the styled train step on a
                            resident batch and the runner that starts each arm
                            of an A/B as its own process
    bench_host_loader.py -- the host input path's rates: per worker through
                            the native core, cv2 and the RoI cache, and the
                            whole DataLoader
    bench_e2e.py         -- the plain KRN trainer's throughput from disk,
                            over full frames and over the RoI cache
    ab_bf16_out.py       -- the styled KRN and SPN steps with the styled
                            image stored in bf16 and in f32
    ab_spn_styled.py     -- the styled SPN step with the phase-space and
                            with the plain Ghiasi lowering

Each keeps its JAX counterpart's arguments, defaults and JSON keys, adds the
card's name and power limit under ``"card"``, and runs on the card unless
``--no_cuda`` is given (without a GPU and without it, each raises).
"""
