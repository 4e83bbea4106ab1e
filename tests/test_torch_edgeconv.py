"""The edge-conv wrapper (``ops/edgeconv.py``) and how the generator reaches
it, on the CPU: the plain version against the generator's reflect pad +
``F.conv2d`` bit for bit, in f32 and float64, at odd and even sides from the
smallest a pad of 4 takes to SPN's; the wrapper on a CPU tensor, with and
without grad; the CPU generator's output unchanged; and which layers a bf16
generator on the card sends to the kernel (the card itself is stubbed: the
kernel has no CPU mode, ``tests/test_torch_cuda.py`` runs it).
"""
import pytest
import torch

import speedplusbaseline_tpu_torch.models.ghiasi as ghiasi
from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi, _conv, _nhwc, reflect_pad
from speedplusbaseline_tpu_torch.ops import _build
from speedplusbaseline_tpu_torch.ops.edgeconv import (SHAPES, reflect_conv9x9,
                                                      reflect_conv9x9_plain)

torch.set_num_threads(1)


def _conv9(cin, cout, dtype, seed):
    torch.manual_seed(seed)
    conv = torch.nn.Conv2d(cin, cout, 9).to(dtype)
    with torch.no_grad():
        conv.bias.normal_()
    return conv


def _image(batch, cin, side, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(batch, cin, side, side, generator=g, dtype=torch.float64)
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("side", [5, 9, 16, 227, 228])
@pytest.mark.parametrize("cin,cout", SHAPES)
def test_plain_equals_reflect_pad_then_conv(dtype, side, cin, cout):
    """``reflect_conv9x9_plain`` is the generator's 9x9 layer conv, bit for
    bit, on the (B, H, W, C) view of its channels_last input."""
    conv = _conv9(cin, cout, dtype, side)
    x = _image(1 if side > 100 else 2, cin, side, dtype, side + 1)
    with torch.no_grad():
        ref = _nhwc(_conv(conv, reflect_pad(x, 4)))
        got = reflect_conv9x9_plain(_nhwc(x), conv.weight, conv.bias)
    assert got.shape == (x.shape[0], side, side, cout) and got.dtype == dtype
    assert torch.equal(got, ref)


@pytest.mark.parametrize("cin,cout", SHAPES)
def test_wrapper_takes_the_plain_version_on_the_cpu(cin, cout):
    """A CPU tensor launches nothing; under grad the call is differentiable
    and its gradients are the plain version's."""
    conv = _conv9(cin, cout, torch.float32, 3)
    x = _nhwc(_image(2, cin, 11, torch.float32, 4))
    before = dict(_build.launches)
    with torch.no_grad():
        assert torch.equal(reflect_conv9x9(x, conv.weight, conv.bias),
                           reflect_conv9x9_plain(x, conv.weight, conv.bias))
    xg = x.clone().requires_grad_()
    out = reflect_conv9x9(xg, conv.weight, conv.bias)
    assert out.grad_fn is not None
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    wrt = [xg, conv.weight, conv.bias]
    got = torch.autograd.grad(out, wrt, cot)
    ref = torch.autograd.grad(reflect_conv9x9_plain(xg, conv.weight, conv.bias), wrt, cot)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    assert _build.launches == before


def _old_padded_conv(conv, x):
    """The generator's pad + conv of every layer before the edge-conv kernel."""
    return _nhwc(_conv(conv, reflect_pad(x, conv.kernel_size[0] // 2)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ghiasi_cpu_output_unchanged(monkeypatch, dtype):
    torch.manual_seed(6)
    net = Ghiasi(dtype).to(dtype).eval()
    g = torch.Generator().manual_seed(7)
    x = torch.rand(2, 3, 27, 31, generator=g)
    st = torch.randn(2, 100, generator=g) * 0.5
    with torch.no_grad():
        got = net(x, st)
        monkeypatch.setattr(ghiasi, "_padded_conv", _old_padded_conv)
        ref = net(x, st)
    assert got.dtype == dtype and torch.equal(got, ref)


@pytest.mark.parametrize("dtype,phase_space,routed", [
    (torch.bfloat16, False, [(3, 32), (32, 3)]),
    (torch.float32, False, []),
    (torch.bfloat16, True, []),
])
def test_generator_routes_bf16_edge_layers_through_the_kernel(monkeypatch, dtype, phase_space,
                                                               routed):
    """With every tensor taken for a card tensor, a bf16 generator sends its
    layer0 and layer10 (and no other layer) to ``reflect_conv9x9``, with the
    bf16 weights ``_conv`` would use; the f32 generator and the phase-space
    lowering keep their own convs."""
    calls = []

    def recorder(x, w, b):
        calls.append((x.shape[-1], w.shape[0]))
        assert x.dtype == w.dtype == b.dtype == torch.bfloat16 and x.is_contiguous()
        return reflect_conv9x9_plain(x, w, b)

    monkeypatch.setattr(ghiasi, "_on_card", lambda x: True)
    monkeypatch.setattr(ghiasi, "reflect_conv9x9", recorder)
    torch.manual_seed(8)
    net = Ghiasi(dtype, phase_space=phase_space).eval()
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        out = net(torch.rand(2, 3, 16, 16, generator=g), torch.randn(2, 100, generator=g))
    assert calls == routed
    assert out.shape == (2, 3, 16, 16) and torch.isfinite(out.float()).all()


@pytest.mark.parametrize("kernels,styled,want", [
    ([650.0, 760.0, 640.0, 770.0], [True, False, True, False], (650 + 760 + 640 + 770) / 2e3),
    ([650.0, 760.0, 640.0], [True, False, True, False], None),  # a restyle ran one layer
    ([], [True, False, True, False], None),  # no edge-conv kernel: the parent's program
    ([650.0, 760.0], [False, False], None),  # no restyled step in the stretch
])
def test_edge_conv_ms_reads_the_kernel_by_name(kernels, styled, want):
    """The benchmark's reader: the kernel's device ms a restyled step, known
    by name among the stretch's events, and nothing unless both layers of
    every restyle ran it."""
    from portbench import spec
    from portbench import trace as tr
    from portbench.runners.train_resident import Context

    names = ["void (anonymous namespace)::edge_conv9x9_kernel<3, 32>(__nv_bfloat16 const*)",
             "void (anonymous namespace)::edge_conv9x9_kernel<32, 3>(__nv_bfloat16 const*)"]
    events = [tr.DeviceEvent(names[i % 2], 1000.0 * i, dur, 7) for i, dur in enumerate(kernels)]
    events.append(tr.DeviceEvent("void precomputed_convolve_sgemm<__nv_bfloat16>(int)", 9e3,
                                 500.0, 7))
    cell = spec.cell("spn-b48-styled50")
    ctx = Context(cell.config, cell.traffic, None, events, styled, [], None, 0.0, 0.0, 1)
    got = spec.reader("edge_conv_ms")(ctx)
    assert got == (None if want is None else pytest.approx(want))
