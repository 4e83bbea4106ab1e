"""The mid-conv wrapper (``ops/midconv.py``) and how the generator reaches it,
on the CPU: the plain version against the generator's old upsample +
reflect pad + ``F.conv2d`` bit for bit in float64 (and f32), for each of
layers 1, 2, 8 and 9 at even and odd sides; the wrapper's refusals; its
gradients under grad against autograd through the old composition; the
packed-weight buffers after ``load_state_dict``; the float64 generator's
output unchanged; which layers a bf16 generator on the card sends to the
kernel (the card itself is stubbed: the kernel has no CPU mode,
``tests/test_torch_cuda.py`` runs it); and the benchmark's reader.
"""
import pytest
import torch

import speedplusbaseline_tpu_torch.models.ghiasi as ghiasi
from speedplusbaseline_tpu_torch.models.ghiasi import (ConvInRelu, Ghiasi, UpsampleConvInRelu,
                                                       _conv, _nchw, _nhwc, _padded_conv,
                                                       instance_norm_film, reflect_pad,
                                                       upsample_nearest)
from speedplusbaseline_tpu_torch.ops import _build
from speedplusbaseline_tpu_torch.ops.midconv import (SHAPES, out_side, pack, reflect_conv3x3,
                                                     reflect_conv3x3_plain)

torch.set_num_threads(1)
LAYERS = dict(zip(("layer1", "layer2", "layer8", "layer9"), SHAPES))


def _conv3(cin, cout, stride, dtype, seed):
    torch.manual_seed(seed)
    conv = torch.nn.Conv2d(cin, cout, 3, stride).to(dtype)
    with torch.no_grad():
        conv.bias.normal_()
    return conv


def _image(batch, cin, h, w, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(batch, cin, h, w, generator=g, dtype=torch.float64)
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _old(conv, x, upsample):
    """The generator's conv of these layers before the mid-conv kernel."""
    if upsample > 1:
        x = upsample_nearest(x, upsample)
    return _nhwc(_conv(conv, reflect_pad(x, 1)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("side", [16, 15])
@pytest.mark.parametrize("layer", list(LAYERS))
def test_plain_equals_upsample_pad_then_conv(dtype, side, layer):
    """``reflect_conv3x3_plain`` on the packed weight is the generator's old
    composition bit for bit, on the (B, H, W, C) view of its channels_last
    input, with the output side the stride or the upsample gives."""
    cin, cout, stride, up = LAYERS[layer]
    conv = _conv3(cin, cout, stride, dtype, side)
    x = _image(2, cin, side, side + 3, dtype, side + 1)
    with torch.no_grad():
        ref = _old(conv, x, up)
        got = reflect_conv3x3_plain(_nhwc(x), pack(conv.weight, dtype), conv.bias, stride, up)
    assert got.shape == (2, out_side(side, stride, up), out_side(side + 3, stride, up), cout)
    assert got.dtype == dtype and torch.equal(got, ref)


@pytest.mark.parametrize("layer", list(LAYERS))
def test_wrapper_takes_the_plain_version_on_the_cpu(layer):
    """A CPU tensor launches nothing, and the wrapper's result is the plain
    version's."""
    cin, cout, stride, up = LAYERS[layer]
    conv = _conv3(cin, cout, stride, torch.float64, 3)
    x = _nhwc(_image(2, cin, 7, 6, torch.float64, 4))
    w = pack(conv.weight, torch.float64)
    before = dict(_build.launches)
    with torch.no_grad():
        assert torch.equal(reflect_conv3x3(x, w, conv.bias, stride, up),
                           reflect_conv3x3_plain(x, w, conv.bias, stride, up))
    assert _build.launches == before


@pytest.mark.parametrize("layer", list(LAYERS))
def test_gradients_match_autograd_through_the_old_composition(layer):
    """Under grad the call goes through ``PlainVJP``; the gradients of x, of
    the conv weight (through the packing) and of the bias equal autograd's
    through upsample + reflect pad + ``F.conv2d``, in float64."""
    cin, cout, stride, up = LAYERS[layer]
    conv = _conv3(cin, cout, stride, torch.float64, 5)
    x = _image(2, cin, 9, 8, torch.float64, 6).requires_grad_()
    before = dict(_build.launches)
    out = reflect_conv3x3(_nhwc(x), pack(conv.weight, torch.float64), conv.bias, stride, up)
    assert out.grad_fn is not None
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(7), dtype=torch.float64)
    wrt = [x, conv.weight, conv.bias]
    got = torch.autograd.grad(out, wrt, cot)
    ref = torch.autograd.grad(_old(conv, x, up), wrt, cot)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)
    assert _build.launches == before


def _args(layer):
    cin, cout, stride, up = LAYERS[layer]
    return (torch.rand(2, 6, 6, cin), torch.randn(cout, 3, 3, cin), torch.randn(cout), stride,
            up)


@pytest.mark.parametrize("case,match", [
    ("integer x", "contiguous"),
    ("w in another dtype", "w must be"),
    ("bias in bf16", "b must be"),
    ("x not contiguous", "contiguous"),
    ("w not contiguous", "w must be"),
    ("another channel pair", "one of"),
    ("another stride", "one of"),
    ("w of another shape", "shape"),
    ("side under 2", "at least 2"),
])
def test_wrapper_refuses_what_it_does_not_take(case, match):
    x, w, b, stride, up = _args("layer2")
    if case == "integer x":
        x = (x * 10).to(torch.int32)
    elif case == "w in another dtype":
        w = w.double()
    elif case == "bias in bf16":
        x, w, b = x.bfloat16(), w.bfloat16(), b.bfloat16()
    elif case == "x not contiguous":
        x = x.transpose(1, 2)
    elif case == "w not contiguous":
        w = w.transpose(1, 2)
    elif case == "another channel pair":
        x = x[..., :32].contiguous()
    elif case == "another stride":
        stride = 1
    elif case == "w of another shape":
        w = torch.randn(128, 1, 9, 64)
    elif case == "side under 2":
        x = x[:, :1].contiguous()
    with pytest.raises(ValueError, match=match):
        reflect_conv3x3(x, w, b, stride, up)


def test_bf16_on_the_cpu_is_the_plain_version():
    """The kernel's operands (bf16 x and w, f32 bias) on the CPU: computed in
    f32 from the same values, rounded to bf16 once."""
    x, w, b, stride, up = _args("layer8")
    x, w = x.bfloat16(), w.bfloat16()
    got = reflect_conv3x3(x, w, b, stride, up)
    ref = reflect_conv3x3_plain(x.float(), w.float(), b, stride, up).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref)


@pytest.mark.parametrize("phase_space", [False, True])
def test_packed_weights_are_remade_after_load_state_dict(phase_space):
    """Each 3x3 layer's bf16 OHWI buffer follows the init and is remade from
    the loaded convs; it is not part of the state dict; the 9x9 layers have
    none."""
    torch.manual_seed(0)
    net = Ghiasi(phase_space=phase_space)
    torch.manual_seed(1)
    donor = Ghiasi()
    for name in LAYERS:
        layer = getattr(net, name)
        assert torch.equal(layer.w_ohwi, pack(layer.conv.weight, torch.bfloat16))
        assert layer.w_ohwi.dtype == torch.bfloat16 and layer.w_ohwi.is_contiguous()
    before = net.layer8.w_ohwi.clone()
    net.load_state_dict(donor.state_dict())
    for name in LAYERS:
        w = getattr(donor, name).conv.weight
        assert torch.equal(getattr(net, name).w_ohwi, pack(w, torch.bfloat16))
    assert not torch.equal(before, net.layer8.w_ohwi)
    assert not any("w_ohwi" in k for k in net.state_dict())
    assert not hasattr(net.layer0, "w_ohwi") and not hasattr(net.layer10, "w_ohwi")


def _old_conv_in_relu(self, x):
    return _nchw(instance_norm_film(_padded_conv(self.conv, x), relu=True))


def _old_upsample_conv_in_relu(self, x, style):
    gamma, beta = self.fc_gamma(style), self.fc_beta(style)
    if self.upsample:
        x = upsample_nearest(x, self.upsample)
    return _nchw(instance_norm_film(_padded_conv(self.conv, x), gamma, beta,
                                    relu=self.use_relu))


@pytest.mark.parametrize("side", [(16, 16), (15, 17)])
def test_float64_generator_output_unchanged(monkeypatch, side):
    """The float64 generator gives its old output bit for bit: the layers'
    new forward takes the old upsample + pad + conv off the card."""
    torch.manual_seed(6)
    net = Ghiasi(torch.float64).to(torch.float64).eval()
    g = torch.Generator().manual_seed(7)
    x = torch.rand(2, 3, *side, generator=g)
    st = torch.randn(2, 100, generator=g) * 0.5
    with torch.no_grad():
        got = net(x, st)
        monkeypatch.setattr(ConvInRelu, "forward", _old_conv_in_relu)
        monkeypatch.setattr(UpsampleConvInRelu, "forward", _old_upsample_conv_in_relu)
        ref = net(x, st)
    assert got.dtype == torch.float64 and torch.equal(got, ref)


@pytest.mark.parametrize("dtype,phase_space,routed", [
    (torch.bfloat16, False, list(SHAPES)),
    (torch.float32, False, []),
    (torch.bfloat16, True, []),
])
def test_generator_routes_bf16_3x3_layers_through_the_kernel(monkeypatch, dtype, phase_space,
                                                             routed):
    """With every tensor taken for a card tensor, a bf16 generator sends its
    layers 1, 2, 8 and 9 (and no other layer) to ``reflect_conv3x3`` with
    their stride or upsample, the cached bf16 weights and the f32 bias, on
    the pre-upsample input; the f32 generator and the phase-space lowering
    keep their own convs. The output equals the old route's within bf16's
    rounding of the two paths' sums."""
    calls = []

    def recorder(x, w, b, stride, upsample):
        cin, cout = x.shape[-1], w.shape[0]
        layer = {s: n for n, s in LAYERS.items()}[(cin, cout, stride, upsample)]
        assert w is getattr(net, layer).w_ohwi
        assert x.dtype == w.dtype == torch.bfloat16 and b.dtype == torch.float32
        assert x.is_contiguous()
        calls.append((cin, cout, stride, upsample))
        return reflect_conv3x3(x, w, b, stride, upsample)

    monkeypatch.setattr(ghiasi, "_on_card", lambda x: True)
    monkeypatch.setattr(ghiasi, "reflect_conv3x3", recorder)
    torch.manual_seed(8)
    net = Ghiasi(dtype, phase_space=phase_space).eval()
    g = torch.Generator().manual_seed(9)
    x, st = torch.rand(2, 3, 16, 16, generator=g), torch.randn(2, 100, generator=g)
    with torch.no_grad():
        out = net(x, st)
        monkeypatch.setattr(ghiasi, "reflect_conv3x3", lambda *a: pytest.fail("routed"))
        monkeypatch.setattr(ConvInRelu, "forward", _old_conv_in_relu)
        monkeypatch.setattr(UpsampleConvInRelu, "forward", _old_upsample_conv_in_relu)
        old = net(x, st)
    assert calls == routed
    assert out.shape == (2, 3, 16, 16) and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), old.float(), atol=2.0 ** -6, rtol=0)


def test_trainable_generator_packs_the_live_weights(monkeypatch):
    """Under grad, with the conv weights requiring grad, each routed layer
    packs its live weight, so that the loss's gradient reaches the conv
    weight: equal to the old route's, computed in f32 from the same bf16
    values."""
    monkeypatch.setattr(ghiasi, "_on_card", lambda x: True)
    torch.manual_seed(10)
    layer = Ghiasi(torch.bfloat16).layer8
    g = torch.Generator().manual_seed(11)
    x = torch.rand(2, 128, 5, 6, generator=g).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    y = layer._conv_nhwc(x, 2)
    (gw,) = torch.autograd.grad(y.float().square().sum(), layer.conv.weight)
    xf = x.float()
    ref = reflect_conv3x3_plain(_nhwc(xf), pack(layer.conv.weight, torch.bfloat16).float(),
                                layer.conv.bias, 1, 2).bfloat16()
    assert torch.equal(y, ref)
    assert gw.shape == layer.conv.weight.shape and gw.abs().sum() > 0


@pytest.mark.parametrize("kernels,styled,want", [
    ([300.0, 200.0, 600.0, 650.0] * 2, [True, False, True, False], 3500.0 / 2e3),
    ([300.0, 200.0, 600.0] * 2, [True, False, True, False], None),  # a layer went elsewhere
    ([], [True, False, True, False], None),  # no mid-conv kernel: the parent's program
    ([300.0, 200.0, 600.0, 650.0], [False, False], None),  # no restyled step in the stretch
])
def test_mid_conv_ms_reads_the_kernel_by_name(kernels, styled, want):
    """The benchmark's reader: the kernel's device ms a restyled step, known
    by name among the stretch's events (not B1's ``conv3x3_tc_kernel``), and
    nothing unless all four layers of every restyle ran it."""
    from portbench import spec
    from portbench import trace as tr
    from portbench.runners.train_resident import Context

    names = ["void (anonymous namespace)::mid_conv3x3_kernel<32, 64, false>(__nv_bfloat16 "
             "const*)", "void (anonymous namespace)::mid_conv3x3_kernel<64, 128, false>(int)",
             "void (anonymous namespace)::mid_conv3x3_kernel<128, 64, true>(int)",
             "void (anonymous namespace)::mid_conv3x3_kernel<64, 32, true>(int)"]
    events = [tr.DeviceEvent(names[i % 4], 1000.0 * i, dur, 7) for i, dur in enumerate(kernels)]
    events.append(tr.DeviceEvent("void conv3x3_tc_kernel<__nv_bfloat16, false>(int)", 9e3,
                                 500.0, 7))
    cell = spec.cell("krn-b192-styled50")
    ctx = Context(cell.config, cell.traffic, None, events, styled, [], None, 0.0, 0.0, 1)
    got = spec.reader("mid_conv_ms")(ctx)
    assert got == (None if want is None else pytest.approx(want))
