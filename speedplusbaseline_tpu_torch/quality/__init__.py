"""The end-to-end quality drivers: the port's counterparts of the JAX
package's ``scripts/convergence_run.py``, ``dann_adaptation_run.py``,
``styleaug_ab_run.py``, ``krn_transfer_run.py``, ``dump_krn_backbone.py``,
``dump_spn_convs.py`` and ``probe_spn_memorize.py``, and the Run S seed
sweep.

    common.py            -- labelling and caching through the port's data/,
                            the regeneration rule, the assets mirror, one
                            CLI arm as a subprocess, the Valid/ curve and
                            the per-image error statistics
    convergence_run.py   -- KRN Run B and SPN Run S through the train CLI
    dann_adaptation_run.py -- source-only (train CLI) against DANN (adapt CLI)
    styleaug_ab_run.py   -- source-only against --randomize_texture, and the
                            photometric-only sunlamp split through the test CLI
    dump_krn_backbone.py -- a KRN checkpoint's trunk as a torchvision
                            MobileNetV2 state dict
    krn_transfer_run.py  -- donor -> dump -> convert_weights -> scratch and
                            boot arms
    dump_spn_convs.py    -- SPN conv1-5 in the bvlc_alexnet.npy format
    probe_spn_memorize.py -- SPN on a few fixed batches at a held lr: does
                            the training path overfit them?
    spn_seed_sweep.py    -- Run S's first epochs at many seeds (train CLI),
                            which stall at ln(num_classes), the live-ReLU
                            shares of a run, Fisher's exact test

Each driver keeps its JAX counterpart's flags, defaults, directory layout and
final JSON keys, runs the port's CLIs (``python -m
speedplusbaseline_tpu_torch.{train,adapt,test,convert_weights}``) as
subprocesses, and runs on the card unless ``--no_cuda`` is given. An arm
runs once and a nonzero exit raises; rerunning the same command resumes,
since the CLIs resume from ``checkpoint.pt``.
"""
