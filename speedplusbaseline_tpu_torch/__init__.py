"""speedplusbaseline_tpu_torch: the SPEED+ baseline on PyTorch and CUDA.

The port of ``speedplusbaseline_tpu`` (JAX) to one NVIDIA H100. It keeps
the JAX package's subpackage and module names, so each module's counterpart
is found under the same path:

    config.py, train.py  -- the KRN / SPN training CLI (``python -m
                            speedplusbaseline_tpu_torch.train``)
    test.py, adapt.py,   -- the evaluation, DANN adaptation and label
    preprocess.py           preprocessing CLIs
    engine/              -- train and eval steps, epoch loops, optimizers, state
    models/              -- KRN (MobileNetV2), SPN, RevGrad (DANN), Ghiasi
    augment/             -- photometric augs, style augmentor
    ops/, csrc/          -- hand-written CUDA kernels (sm_90a) + plain versions
    geometry/, metrics/  -- projection, EPnP, SPN position, SPEED score
    data/                -- CSV dataset, host crop, pinned-memory loader,
                            label preprocessing, the fake SPEED+ generator,
                            the RoI cache (built by ``cache_dataset.py``)
    native/, csrc/speedloader.cpp -- the native JPEG decode core (ctypes,
                            built by the host C++ compiler at first use)
    io_utils/            -- checkpoints, summaries, meters, assets
    convert.py           -- JAX parameter trees <-> state_dicts

Models take NCHW tensors in ``torch.channels_last`` memory. Entry points run
on CUDA unless the caller asks for the CPU, and raise when no GPU is present.
It imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"
