"""Phase-space (space-to-depth) convolutions of the Ghiasi generator
(counterpart of ``speedplusbaseline_tpu/ops/phase_conv.py``).

Exact algebraic rewrites that move the generator's full-resolution convs to
half resolution with 4x the channels:

  * reflect-pad-1 + stride-2 3x3 conv      == 2x2 conv on s2d(x) phases
  * nearest-up2 + reflect-pad-1 + 3x3 conv == one 3x3 conv emitting the 4
    output phases (subpixel / transposed-conv identity)
  * reflect-pad-4 + stride-1 9x9 conv      == 5x5 conv on s2d phases with
    phase-structured kernels, for input and output phases alike

The reflect pads happen in phase space: a reflect pad of the full image is a
per-phase edge / reflect / symmetric pad of the s2d blocks.

Tensors are NHWC: (B, H, W, C), as the JAX functions take them; the port's
Ghiasi hands over the (B, H, W, C) view of its channels_last NCHW tensors,
which is that layout in memory. Conv weights are HWIO, as flax's. Channel
packing: s2d block (py, px) of channel c lives at channel (py*2 + px)*C + c
on the input side and the output side alike, the JAX convention;
``F.pixel_unshuffle`` orders the channels c*4 + py*2 + px instead, so it
is not used. The convs are ``F.conv2d`` on the rewritten weights (cuDNN on
the card): a layout rewrite outside any kernel. Plain torch, differentiable.
The convs the generator runs take ``phase_w``, the rewritten kernel, when
the caller keeps it (models/ghiasi.py caches it); ``w`` is then not read.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel order (py*2+px)*C + c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of space_to_depth2: (B, h, w, 4C) -> (B, 2h, 2w, C)."""
    b, h, w, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, c)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """VALID NHWC conv with HWIO weights, in x's dtype; the result is a
    contiguous NHWC tensor."""
    x = _nchw(x).contiguous(memory_format=torch.channels_last)
    return _nhwc(F.conv2d(x, w.permute(3, 2, 0, 1).to(x.dtype), stride=stride))


def _bias(y: torch.Tensor, b: Optional[torch.Tensor], phases: int = 1) -> torch.Tensor:
    """y + b, the bias repeated once per output phase."""
    return y if b is None else y + b.to(y.dtype).repeat(phases)


def _edge_pad(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Edge (replicate) pad of the H and W axes of an NHWC tensor."""
    return _nhwc(F.pad(_nchw(x), (left, right, top, bottom), mode="replicate"))


# ---------------------------------------------------------------------------
# stride-2 3x3 conv (Ghiasi layer1/layer2): reflect-pad-1 + VALID 3x3 s2
# ---------------------------------------------------------------------------

def _phase_kernel_2x2(wp: torch.Tensor) -> torch.Tensor:
    """(4, 4, C, O) taps indexed (2*kh + py, 2*kw + px) -> (2, 2, 4C, O)."""
    _, _, c, o = wp.shape
    wp = wp.reshape(2, 2, 2, 2, c, o).permute(0, 2, 1, 3, 4, 5)  # (kh, kw, py, px, C, O)
    return wp.reshape(2, 2, 4 * c, o)


def phase_weights_s2(w: torch.Tensor) -> torch.Tensor:
    """(3,3,C,O) -> (2,2,4C,O) for the 2x2 conv over s2d phases. Kernel slot
    (kh, py) covers original tap dy = 2*kh + py (dy = 3 is zero)."""
    if w.shape[0] != 3:
        raise ValueError(f"a 3x3 kernel, got {tuple(w.shape)}")
    return _phase_kernel_2x2(F.pad(w, (0, 0, 0, 0, 0, 1, 0, 1)))


def phase_pad_s2(x4: torch.Tensor) -> torch.Tensor:
    """s2d-domain equivalent of reflect-pad-1 before a stride-2 3x3 conv:
    block (py, px) of the padded tensor at (m, n) holds x(2m+py-1, 2n+px-1),
    an edge-padded shift of block (1-py, 1-px) of x4. (B, h, w, 4C) ->
    (B, h+1, w+1, 4C)."""
    c = x4.shape[-1] // 4
    P = [x4[..., i * c:(i + 1) * c] for i in range(4)]  # (py*2+px)

    def pad(block, top, left):
        # top/left shift with edge fill; the bottom/right rows it adds are
        # read only by zero taps.
        return _edge_pad(block, int(top), int(not top), int(left), int(not left))

    return torch.cat([pad(P[3], True, True), pad(P[2], True, False),
                      pad(P[1], False, True), pad(P[0], False, False)], dim=-1)


def conv3x3_s2_phase(x4: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reflect-pad-1 + 3x3 stride-2 conv on the s2d phase tensor x4 (B, h,
    w, 4C) of the (B, 2h, 2w, C) input. Returns (B, h, w, O)."""
    return _bias(_conv(phase_pad_s2(x4), phase_weights_s2(w)), b)


def phase_weights_s2_aligned(w: torch.Tensor) -> torch.Tensor:
    """(3,3,C,O) -> (2,2,4C,O) for the single-edge-pad form: kernel slot
    (kh, py) covers original tap dy = 2*kh + py - 1 (dy = -1 is zero, so the
    pad row's even phase is never read, which makes one whole-tensor edge
    pad equal the reflect boundary)."""
    if w.shape[0] != 3:
        raise ValueError(f"a 3x3 kernel, got {tuple(w.shape)}")
    return _phase_kernel_2x2(F.pad(w, (0, 0, 0, 0, 1, 0, 1, 0)))


def conv3x3_s2_phase_aligned(x4: torch.Tensor, w: Optional[torch.Tensor],
                             b: Optional[torch.Tensor] = None,
                             phase_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv3x3_s2_phase with one top/left edge pad of the whole tensor in
    place of the 4-block shifted concat: output m reads x4 block rows
    {m-1, m}, and the reflect boundary x(-1) = x(1) lands on the pad row's
    odd phase."""
    if phase_w is None:
        phase_w = phase_weights_s2_aligned(w)
    return _bias(_conv(_edge_pad(x4, 1, 0, 1, 0), phase_w), b)


# ---------------------------------------------------------------------------
# nearest-up2 + reflect-pad-1 + 3x3 conv (Ghiasi layer8/layer9)
# ---------------------------------------------------------------------------

# M3_UP[p, ktap, dy]: tap ktap of the aligned kernel covers original weight
# dy for output phase p (out row 2i+p reads up rows {2i+p-1, 2i+p, 2i+p+1} =
# x rows {i-1, i, i} for p=0 and {i, i, i+1} for p=1; an edge pad covers the
# reflect of the upsampled border).
_M3_UP = ((1.0, 0.0, 0.0), (0.0, 1.0, 1.0), (0.0, 0.0, 0.0)), \
         ((0.0, 0.0, 0.0), (1.0, 1.0, 0.0), (0.0, 0.0, 1.0))


def phase_weights_up_aligned(w: torch.Tensor) -> torch.Tensor:
    """(3,3,C,O) -> (3,3,C,4O) aligned-window subpixel kernels, output
    channel (p*2+q)*O + o (space_to_depth2's order)."""
    if w.shape[0] != 3:
        raise ValueError(f"a 3x3 kernel, got {tuple(w.shape)}")
    _, _, c, o = w.shape
    m = torch.tensor(_M3_UP, dtype=w.dtype, device=w.device)
    t = torch.einsum("akd,ble,deco->klcabo", m, m, w)
    return t.reshape(3, 3, c, 4 * o)


def upconv3x3_phase_packed(x: torch.Tensor, w: Optional[torch.Tensor],
                           b: Optional[torch.Tensor] = None,
                           phase_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """nearest-up2 + reflect-pad-1 + VALID 3x3 conv of x (B, h, w, C),
    emitting the packed phase tensor (B, h, w, 4O) = space_to_depth2 of the
    (B, 2h, 2w, O) output: one conv, no shifted-window stack."""
    if phase_w is None:
        phase_w = phase_weights_up_aligned(w)
    return _bias(_conv(_edge_pad(x, 1, 1, 1, 1), phase_w), b, 4)


def phase_instance_norm_packed(z: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                               beta: Optional[torch.Tensor] = None, eps: float = 1e-5,
                               phases: int = 4) -> torch.Tensor:
    """Instance norm over packed phase channels (B, h, w, phases*C): the
    statistics pool over (h, w) and the phases, which are the full-
    resolution per-channel statistics, in f32, with flax's E[x^2] - E[x]^2
    clamped at 0; the elementwise pass stays on the packed layout.
    ``phases=16`` serves conv9x9_phase_dp's double-packed output. gamma and
    beta: optional (B, C) FiLM parameters. Returns z's dtype."""
    b, _, _, cp = z.shape
    c = cp // phases
    zf = z.float()
    m1 = zf.mean(dim=(1, 2))                           # (B, phases*C)
    m2 = zf.square().mean(dim=(1, 2))
    mean = m1.reshape(b, phases, c).mean(dim=1)        # (B, C)
    var = torch.clamp(m2.reshape(b, phases, c).mean(dim=1) - mean.square(), min=0.0)
    scale = torch.rsqrt(var + eps)
    shift = -mean * scale
    if gamma is not None:
        scale = scale * gamma.float()
        shift = shift * gamma.float()
    if beta is not None:
        shift = shift + beta.float()
    scale = scale.repeat(1, phases)[:, None, None, :]
    shift = shift.repeat(1, phases)[:, None, None, :]
    return (zf * scale + shift).to(z.dtype)


# ---------------------------------------------------------------------------
# stride-1 9x9 conv (Ghiasi layer0/layer10): reflect-pad-4 + VALID 9x9
# ---------------------------------------------------------------------------

def phase_weights_9x9(w: torch.Tensor) -> torch.Tensor:
    """(9,9,C,O) -> (5,5,4C,4O): a 5x5 conv over input phases producing the
    4 output phases. Slot (kh, py) for output phase p covers tap
    dy = 2*kh + py - p (out of [0, 8]: zero)."""
    if w.shape[0] != 9:
        raise ValueError(f"a 9x9 kernel, got {tuple(w.shape)}")
    _, _, c, o = w.shape
    # (p, dyp, dx, C, O) with dyp = 2*kh + py, rows shifted down by p
    wr = torch.stack([F.pad(w, (0, 0, 0, 0, 0, 0, p, 1 - p)) for p in (0, 1)])
    wr = wr.reshape(2, 5, 2, 9, c, o)                  # (p, kh, py, dx, C, O)
    wc = torch.stack([F.pad(wr, (0, 0, 0, 0, q, 1 - q)) for q in (0, 1)])
    wc = wc.reshape(2, 2, 5, 2, 5, 2, c, o)            # (q, p, kh, py, kw, px, C, O)
    wc = wc.permute(2, 4, 3, 5, 6, 1, 0, 7)            # (kh, kw, py, px, C, p, q, O)
    return wc.reshape(5, 5, 4 * c, 4 * o)


def _parity_mask(c4: int, axis_bit: int, device) -> torch.Tensor:
    """(1, 1, 1, 4C) mask of the channels whose phase has ``axis_bit`` set
    (2: py, 1: px)."""
    c = c4 // 4
    phase = torch.arange(c4, device=device) // c
    return ((phase & axis_bit) != 0).reshape(1, 1, 1, c4)


def _row_pad_strips_9x9(x4: torch.Tensor):
    """The (top, bottom) 2-row strips of the s2d-domain reflect-pad-4. A
    full-resolution reflect pad of 4 keeps the row parity, so each phase pads
    from its own rows, but the mirror decides which: even phases reflect
    about row 0 (rows 2, 1), odd phases about the half sample (rows 1, 0),
    and the two swap at the bottom edge. Chosen by a channel-parity mask."""
    h = x4.shape[1]
    is_py1 = _parity_mask(x4.shape[-1], 2, x4.device)
    top = torch.where(is_py1, x4[:, 0:2].flip(1), x4[:, 1:3].flip(1))
    bot = torch.where(is_py1, x4[:, h - 3:h - 1].flip(1), x4[:, h - 2:h].flip(1))
    return top, bot


def _col_pad_strips_9x9(t: torch.Tensor):
    """Column analog of _row_pad_strips_9x9: the (left, right) 2-col strips."""
    w = t.shape[2]
    is_px1 = _parity_mask(t.shape[-1], 1, t.device)
    left = torch.where(is_px1, t[:, :, 0:2].flip(2), t[:, :, 1:3].flip(2))
    right = torch.where(is_px1, t[:, :, w - 3:w - 1].flip(2), t[:, :, w - 2:w].flip(2))
    return left, right


def phase_pad_9x9(x4: torch.Tensor) -> torch.Tensor:
    """s2d-domain reflect-pad-4: (B, h, w, 4C) -> (B, h+4, w+4, 4C), from
    row and column strips over the whole 4C channel axis."""
    top, bot = _row_pad_strips_9x9(x4)
    t = torch.cat([top, x4, bot], dim=1)
    left, right = _col_pad_strips_9x9(t)
    return torch.cat([left, t, right], dim=2)


def conv9x9_phase(x4: torch.Tensor, w: Optional[torch.Tensor],
                  b: Optional[torch.Tensor] = None,
                  phase_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reflect-pad-4 + 9x9 stride-1 conv in phase space: x4 (B, h, w, 4C)
    s2d input -> (B, h, w, 4O) phase output (depth_to_space2 gives the
    (B, 2h, 2w, O) image)."""
    if phase_w is None:
        phase_w = phase_weights_9x9(w)
    return _bias(_conv(phase_pad_9x9(x4), phase_w), b, 4)


def phase_weights_9x9_dp(w: torch.Tensor) -> torch.Tensor:
    """(9,9,C,O) -> (6,6,4C,16O) stride-2 kernel emitting the double-packed
    output (the s2d of the phase output): K2[qr+tr, qc+tc, :, (qr*2+qc)*4O +
    p] = W1[tr, tc, :, p], W1 the 5x5 phase kernel. Each outer phase q uses
    25 of the 36 taps."""
    w1 = phase_weights_9x9(w)  # (5, 5, 4C, 4O)
    c4, o4 = w1.shape[2], w1.shape[3]
    k2 = w1.new_zeros((6, 6, c4, 4 * o4))
    for qr in range(2):
        for qc in range(2):
            q = qr * 2 + qc
            k2[qr:qr + 5, qc:qc + 5, :, q * o4:(q + 1) * o4] += w1
    return k2


def conv9x9_phase_dp(x4: torch.Tensor, w: Optional[torch.Tensor],
                     b: Optional[torch.Tensor] = None,
                     phase_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reflect-pad-4 + 9x9 conv emitting the double-packed output: x4 (B, h,
    w, 4C) -> (B, h/2, w/2, 16O), the s2d of conv9x9_phase's output (two
    depth_to_space2 give the full image)."""
    if phase_w is None:
        phase_w = phase_weights_9x9_dp(w)
    return _bias(_conv(phase_pad_9x9(x4), phase_w, stride=2), b, 16)


def phase_instance_norm(z: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                        beta: Optional[torch.Tensor] = None, eps: float = 1e-5,
                        phase_axis: Optional[int] = None) -> torch.Tensor:
    """Instance norm whose statistics pool over (h, w) and the 4 phases: the
    full-resolution per-channel statistics, two-pass in f32.

    z: (B, h, w, 4, C) (phase_axis=3) or (B, h, w, 4C) (phases packed in the
    channels, as conv9x9_phase emits). gamma, beta: optional (B, C) FiLM
    parameters. Returns z's dtype and shape."""
    packed = phase_axis is None
    if packed:
        b, h, w, c4 = z.shape
        z = z.reshape(b, h, w, 4, c4 // 4)
    zf = z.float()
    mean = zf.mean(dim=(1, 2, 3), keepdim=True)
    var = (zf - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    y = (zf - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma[:, None, None, None, :].float()
    if beta is not None:
        y = y + beta[:, None, None, None, :].float()
    y = y.to(z.dtype)
    return y.reshape(b, h, w, c4) if packed else y
