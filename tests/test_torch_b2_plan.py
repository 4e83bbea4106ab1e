"""Kernel B2's single-read (cluster) arithmetic and its path plan, on the CPU.

``csrc/instancenorm.cu::in_cluster_kernel`` cannot run here, so
``_emulate_cluster`` repeats its arithmetic in float32 torch: each sample's
flat slab is cut into K byte ranges; in each range, thread t's slot k sums
the elements at t * VEC + k of every sweep, in order; the slots are halved
while the halves stay channel-aligned and the rest is summed per channel, in
order; the K ranges' channel sums are merged in rank order into the mean;
then the same for the centred squares. That is held to the Pallas kernel in
interpret mode and to a float64 reference at 1e-5, with a mean 10x the std
too (two exact passes need no shift). At that mean the Pallas kernel itself
is off float64 by up to ~8e-5: it takes var = s2/n - mean^2 in f32, which
cancels (ours stays within 2.1e-6). So the Pallas comparison is 1e-5 at mean
0 and 2e-4 at mean 10x the std; float64 holds both at 1e-5. ``plan`` is
checked at the main path's sites.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speedplusbaseline_tpu.ops.pallas_instancenorm import instance_norm_film_pallas
from speedplusbaseline_tpu_torch.ops import instancenorm as inf

torch.set_num_threads(1)

# Shape -> K, each range a whole number of 16-byte vectors (f32), with ranges
# that start mid-row at C = 16 and C = 3.
EMULATED = {(2, 8, 8, 32): 8, (3, 9, 7, 16): 4, (2, 8, 8, 3): 3}
B, S = 48, 224
SITES = {"layer0": (B, S, S, 32), "layer1": (B, S // 2, S // 2, 64),
         "layer2": (B, S // 4, S // 4, 128), "layer8": (B, S // 2, S // 2, 64),
         "layer9": (B, S, S, 32), "layer10": (B, S, S, 3)}


def _block_channel_sums(vals, threads, vec, C, c0):
    """One block's per-channel sums of its range, as the kernel takes them."""
    n = vals.numel()
    sweeps = -(-n // (threads * vec))
    padded = torch.zeros(sweeps * threads * vec)
    padded[:n] = vals
    rows = padded.view(sweeps, threads * vec)
    red = rows[0].clone()
    for s in range(1, sweeps):
        red += rows[s]
    length = threads * vec
    while (length // C) % 2 == 0:
        h = length // 2
        red[:h] += red[h:length]
        length = h
    per = red[:length].view(length // C, C)
    out = per[0].clone()
    for m in range(1, length // C):
        out += per[m]
    return torch.roll(out, c0)  # out[(c0 + c) % C] = per-position sum c


def _emulate_cluster(x, gamma, beta, relu, K, eps=1e-5):
    Bx, H, W, C = x.shape
    vec = 4  # f32
    threads = inf.cluster_threads(C, vec)
    assert threads and (H * W * C * 4) % (16 * K) == 0
    n_el = H * W * C // K
    out = torch.empty_like(x)
    for b in range(Bx):
        ranges = x[b].reshape(K, n_el)
        c0s = [(r * n_el) % C for r in range(K)]
        total = torch.zeros(C)
        for r in range(K):
            total += _block_channel_sums(ranges[r], threads, vec, C, c0s[r])
        mean = total / (H * W)
        total = torch.zeros(C)
        for r in range(K):
            ch = (c0s[r] + torch.arange(n_el)) % C
            d = ranges[r] - mean[ch]
            total += _block_channel_sums(d * d, threads, vec, C, c0s[r])
        var = total / (H * W)
        sc = torch.rsqrt(var + eps) * (gamma[b] if gamma is not None else 1.0)
        sh = (beta[b] if beta is not None else 0.0) - mean * sc
        y = x[b] * sc + sh
        out[b] = torch.relu(y) if relu else y
    return out


@pytest.mark.parametrize("shape", list(EMULATED))
@pytest.mark.parametrize("mean", [0.0, 10.0])
@pytest.mark.parametrize("film,relu", [(False, False), (True, True), (True, False)])
def test_cluster_arithmetic_matches_pallas(shape, mean, film, relu):
    rs = np.random.RandomState(sum(shape) + int(mean) + 2 * film + relu)
    x = (rs.randn(*shape) + mean).astype(np.float32)  # std 1: mean 10x the std
    g = rs.randn(shape[0], shape[3]).astype(np.float32) if film else None
    b = rs.randn(shape[0], shape[3]).astype(np.float32) if film else None
    pallas = np.asarray(instance_norm_film_pallas(
        jnp.asarray(x), None if g is None else jnp.asarray(g),
        None if b is None else jnp.asarray(b), relu=relu, interpret=True))
    x64 = x.astype(np.float64)
    ref = (x64 - x64.mean(axis=(1, 2), keepdims=True)) / np.sqrt(
        x64.var(axis=(1, 2), keepdims=True) + 1e-5)
    if film:
        ref = ref * g[:, None, None, :] + b[:, None, None, :]
    if relu:
        ref = np.maximum(ref, 0.0)
    ours = _emulate_cluster(torch.from_numpy(x), None if g is None else torch.from_numpy(g),
                            None if b is None else torch.from_numpy(b), relu,
                            EMULATED[shape]).numpy()
    np.testing.assert_allclose(ours, pallas, atol=1e-5 if mean == 0.0 else 2e-4)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize("layer", list(SITES))
def test_plan_puts_every_bf16_site_on_one_read(layer):
    """With the card's limits as plan() assumes them (an H100 runs 16-block
    clusters of 200 KB blocks), every bf16 site of the main path reads x
    once, in K ranges on 16-byte bounds that fit one block."""
    shape = SITES[layer]
    p = inf.plan(shape, torch.bfloat16)
    slab = shape[1] * shape[2] * shape[3] * 2
    assert p.path == "cluster"
    assert 1 <= p.k <= inf.MAX_CLUSTER and p.k * p.block_bytes == slab
    assert p.block_bytes % 16 == 0
    assert p.block_bytes < p.smem_bytes <= inf.SMEM_PER_BLOCK
    assert p.threads % 32 == 0 and p.threads * p.vec % shape[3] == 0
    if layer not in ("layer0", "layer9"):  # 3.2 MB / 16 blocks: one block per SM
        assert 2 * (p.smem_bytes + inf.SMEM_RESERVED) <= inf.SMEM_PER_SM


def test_plan_layer0_without_16_block_clusters():
    """Where the card runs no 16-block cluster of 200 KB blocks, layer0/9 go
    two-pass, with 16-byte loads."""
    shape = SITES["layer0"]
    p = inf.plan(shape, torch.bfloat16, lambda k, threads, smem: k < 16 or smem < 115_000)
    assert p.path == "two_pass" and p.vec == 8
    assert p.rows_per_chunk * p.nchunks >= S * S


@pytest.mark.parametrize("shape,dtype,vec,ct", [
    ((48, 224, 224, 32), torch.float32, 4, 8),    # 6.4 MB slab: no cluster holds it
    ((2, 237, 237, 32), torch.bfloat16, 8, 4),    # just past what 16 blocks hold
    ((3, 9, 7, 3), torch.bfloat16, 1, 4),         # 378 B: no 16-byte split, no vectors
])
def test_plan_two_pass_shapes(shape, dtype, vec, ct):
    p = inf.plan(shape, dtype)
    assert (p.path, p.vec, p.ct) == ("two_pass", vec, ct)
    assert p.rows_per_chunk * (p.nchunks - 1) < shape[1] * shape[2]
    assert p.rows_per_chunk * p.nchunks >= shape[1] * shape[2]


def test_plan_edge_of_the_cluster_path():
    """236^2 x 32 bf16 is the largest square plane of 32 channels that 16
    blocks hold."""
    p = inf.plan((2, 236, 236, 32), torch.bfloat16)
    assert p.path == "cluster" and p.k == 16 and p.smem_bytes <= inf.SMEM_PER_BLOCK
