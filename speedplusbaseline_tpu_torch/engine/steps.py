"""KRN, SPN and DANN train steps and KRN and SPN eval steps (counterpart of
``speedplusbaseline_tpu/engine/steps.py``: ``make_{krn,spn,dann}_train_step``,
``make_{krn,spn}_eval_step``; reference trainer.py:41-199, dann.py:38-117,
inference.py:43-225).

A KRN step: uint8 -> [0, 1] on the device, the photometric augs, the Ghiasi
restyle when the host gate says so, the forward, ``krn_loss``, backward,
clip by global norm 1.0 and the optimizer step. An SPN step has no
photometric augs: the restyle, the forward with dropout, ``spn_loss`` in
f32, backward, clip by value 1.0 and the step. ``--use_fp16`` means a
bfloat16 autocast around the forward with f32 parameters and no GradScaler,
as the JAX package's bf16 compute; the restyle runs in the style
augmentor's own dtype.

A DANN step (KRN only) runs the photometric augs on a labelled source
batch and an unlabelled target batch (the target with dummy zero
keypoints), two train-mode forwards of ``RevGrad``, source then target, so
the BatchNorm running statistics move as JAX's ``bs1`` -> ``bs2``, and one
backward of the pose loss plus both domain losses through the gradient
reversal layer; then clip by global norm 1.0 and the step. It has no
restyle.

The eval steps run the forward in eval mode under ``torch.inference_mode``
(bf16 autocast with ``--use_fp16``), then the pose and the SPEED scores in
f32 on the same device, batched, with no host sync: KRN by EPnP on the RoI-
denormalized keypoints; SPN by top-k over the weight head, a softmax, the
weighted mean of the class quaternions and the Gauss-Newton position from
the csv bbox. The pose and score are thousands of small kernels whose
launches, not their work, set the time; with no sync in them they are
captured once per batch size as a CUDA graph and replayed.

Under data parallelism (``parallel/mesh.py``: a default process group) a
step gets this rank's rows of the global batch. The train steps draw every
random number of the global batch from the (seed, step) generator, in the
one-process order, and keep their rows: the aug draws, the style normals
and SPN's dropout masks, and both of DANN's streams. The loss is the global
batch's, from this rank's outputs and the other ranks' (``global_rows``),
and the gradients are summed over the ranks before the clip. So N ranks
take the one-process step of the same global batch.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..augment.photometric import apply_augment, draw_augment
from ..geometry import (compute_position_spn_batched, f32_math, keypoints_to_pose,
                        weighted_mean_quaternion)
from ..io_utils.spans import span
from ..metrics import speed_score_batched
from ..models.ghiasi import EMBED_DIM
from ..models.krn import krn_loss
from ..models.revgrad import bce_with_logits
from ..models.spn import spn_loss
from ..parallel.mesh import all_reduce_grads, global_batch, global_rows
from .optim import clip_gradients
from .state import TrainState


def images_to_float(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 from the loader -> (B, 3, H, W) float32 in [0, 1],
    channels_last (the permute is a view; the loader ships 4x fewer bytes
    than f32). Float inputs pass through, permuted."""
    x = images.permute(0, 3, 1, 2)
    if x.dtype == torch.uint8:
        x = x.float() * (1.0 / 255.0)
    return x.contiguous(memory_format=torch.channels_last)


def krn_step(state: TrainState, images: torch.Tensor, keypts: torch.Tensor,
             draws: Dict[str, torch.Tensor], fp16: bool, style_aug=None,
             generator: Optional[torch.Generator] = None,
             z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One KRN step on given aug draws (and optional style normals ``z``).
    ``style_aug=None`` is the plain step. Returns the loss terms (device
    scalars, detached)."""
    with span("speedplus.augment"):
        x, kp = apply_augment(images_to_float(images), keypts, draws)
    if style_aug is not None:
        x = style_aug(x, generator, z).to(x.dtype)

    with span("speedplus.forward"):
        model = state.model
        model.train()
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=fp16):
            xc, yc = model(x)
        loss, sm = krn_loss(*(global_rows(t) for t in (xc.float(), yc.float(), kp)))
    return _update(state, "krn", loss, sm)


def _update(state: TrainState, model_name: str, loss, sm, dann: bool = False,
            clip: bool = True) -> Dict[str, torch.Tensor]:
    """Backward, the sum of the gradients over the ranks, the model's clip
    (unless ``clip`` is false), the optimizer step; the detached loss terms."""
    with span("speedplus.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with span("speedplus.all_reduce"):
        all_reduce_grads(state.model.parameters())
    if clip:
        with span("speedplus.clip"):
            clip_gradients(model_name, state.model.parameters(), dann)
    with span("speedplus.optimizer"):
        state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in sm.items()}


def _draws(gen: torch.Generator, images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The aug draws of this rank's rows of the global batch of which
    ``images`` (B, H, W, 3) are the rows (the whole batch in one process)."""
    total, rows = global_batch(images.shape[0])
    d = draw_augment(gen, total, (images.shape[3], images.shape[1], images.shape[2]))
    return {k: v[rows] for k, v in d.items()}


def _style_normals(gen: torch.Generator, n: int) -> torch.Tensor:
    """The style augmentor's embedding normals for this rank's ``n`` rows of
    the global batch: the draw ``StyleAugmentor.sample_embedding`` makes."""
    total, rows = global_batch(n)
    return torch.randn((total, EMBED_DIM), generator=gen, device=gen.device)[rows]


def make_krn_train_step(cfg, device: torch.device, style_aug=None):
    """Returns fn(state, batch, styled) -> loss terms. The per-batch styled /
    plain choice is the caller's (the host gate in engine/loops.py). The aug
    and style draws come from a device generator reseeded from (seed, step),
    as the JAX step folds the step into its key, so a resumed run draws what
    an uninterrupted one would."""
    gen = torch.Generator(device=device)

    def train_step(state: TrainState, batch, styled: bool):
        gen.manual_seed((cfg.seed << 32) + state.step)
        images = batch["image"]
        with span("speedplus.augment"):
            draws = _draws(gen, images)
            z = _style_normals(gen, images.shape[0]) if styled else None
        return krn_step(state, images, batch["keypts"], draws, cfg.fp16,
                        style_aug if styled else None, gen, z)

    return train_step


def dann_step(state: TrainState, src_images: torch.Tensor, keypts: torch.Tensor,
              src_draws: Dict[str, torch.Tensor], tgt_images: torch.Tensor,
              tgt_draws: Dict[str, torch.Tensor], alpha: float,
              fp16: bool) -> Dict[str, torch.Tensor]:
    """One DANN step on given aug draws of both streams; ``alpha`` scales
    the reversed gradient. Returns {loss_pose, loss_source, loss_target}
    (device scalars, detached)."""
    with span("speedplus.augment"):
        xs, kp = apply_augment(images_to_float(src_images), keypts, src_draws)
        dummy = keypts.new_zeros((tgt_images.shape[0], *keypts.shape[1:]))
        xt, _ = apply_augment(images_to_float(tgt_images), dummy, tgt_draws)

    with span("speedplus.forward"):
        model = state.model
        model.train()
        with torch.autocast(xs.device.type, dtype=torch.bfloat16, enabled=fp16):
            (xc, yc), dom_src = model(xs, alpha)
            with span("speedplus.target"):
                _, dom_tgt = model(xt, alpha)
        xc, yc, kp, dom_src, dom_tgt = (global_rows(t) for t in (xc.float(), yc.float(), kp,
                                                                 dom_src, dom_tgt))
        loss_pose, _ = krn_loss(xc, yc, kp)
        loss_source = bce_with_logits(dom_src, torch.ones_like(dom_src))
        loss_target = bce_with_logits(dom_tgt, torch.zeros_like(dom_tgt))
    sm = {"loss_pose": loss_pose, "loss_source": loss_source, "loss_target": loss_target}
    return _update(state, "krn", loss_pose + loss_source + loss_target, sm, dann=True)


# Added to the (seed, step) seed of the target stream's generator, so the two
# streams draw independently.
_TARGET_STREAM = 1 << 63


def make_dann_train_step(cfg, device: torch.device):
    """Returns fn(state, source_batch, target_batch, alpha) -> {loss_pose,
    loss_source, loss_target}. Each stream's aug draws come from its own
    device generator, reseeded from (seed, step) and the stream, as
    make_krn_train_step does, so a resumed run draws what an uninterrupted
    one would."""
    src_gen, tgt_gen = torch.Generator(device=device), torch.Generator(device=device)

    def train_step(state: TrainState, source_batch, target_batch, alpha: float):
        seed = (cfg.seed << 32) + state.step
        src_gen.manual_seed(seed)
        tgt_gen.manual_seed(seed + _TARGET_STREAM)
        src, tgt = source_batch["image"], target_batch["image"]
        with span("speedplus.augment"):
            src_draws, tgt_draws = _draws(src_gen, src), _draws(tgt_gen, tgt)
        return dann_step(state, src, source_batch["keypts"], src_draws, tgt, tgt_draws, alpha,
                         cfg.fp16)

    return train_step


def spn_step(state: TrainState, images: torch.Tensor, y_classes: torch.Tensor,
             y_weights: torch.Tensor, fp16: bool, style_aug=None,
             generator: Optional[torch.Generator] = None,
             z: Optional[torch.Tensor] = None, clip: bool = True) -> Dict[str, torch.Tensor]:
    """One SPN step; ``style_aug=None`` is the plain step. The restyle draws
    its embedding normals (or takes ``z``) and then the forward its dropout
    masks from ``generator``; ``clip=False`` leaves out the clip by value
    (the memorization probe's ``--no_clip``). Returns {loss_c, loss_r}
    (device scalars, detached)."""
    x = images_to_float(images)
    if style_aug is not None:
        x = style_aug(x, generator, z).to(x.dtype)
    with span("speedplus.forward"):
        model = state.model
        model.train()
        total, rows = global_batch(x.shape[0])
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=fp16):
            classes, weights = model(x, generator, (rows.start or 0, total))
        loss, sm = spn_loss(*(global_rows(t.float()) for t in (classes, weights, y_classes,
                                                                 y_weights)))
    return _update(state, "spn", loss, sm, clip=clip)


def make_spn_train_step(cfg, device: torch.device, style_aug=None, clip: bool = True):
    """Returns fn(state, batch, styled) -> {loss_c, loss_r}; the generator is
    reseeded from (seed, step) as in make_krn_train_step. ``clip``: see
    spn_step."""
    gen = torch.Generator(device=device)

    def train_step(state: TrainState, batch, styled: bool):
        gen.manual_seed((cfg.seed << 32) + state.step)
        images = batch["image"]
        z = _style_normals(gen, images.shape[0]) if styled else None
        return spn_step(state, images, batch["y_classes"], batch["y_weights"],
                        cfg.fp16, style_aug if styled else None, gen, z, clip)

    return train_step


def make_train_step(cfg, device: torch.device, style_aug=None):
    """The train step of ``cfg.model_name``."""
    make = make_spn_train_step if cfg.model_name == "spn" else make_krn_train_step
    return make(cfg, device, style_aug)


class CudaGraphed:
    """``fn(*tensors) -> dict of tensors``, replayed from a CUDA graph
    captured at the first call with each set of input shapes; on the CPU,
    ``fn`` itself. ``fn`` must not sync with the host. Returns copies, so a
    later replay does not overwrite what the caller holds."""

    def __init__(self, fn):
        self.fn = fn
        self.graphs = {}

    def __call__(self, *args):
        if args[0].device.type != "cuda":
            return self.fn(*args)
        key = tuple(a.shape for a in args)
        if key not in self.graphs:
            with torch.cuda.device(args[0].device):
                static_in = [a.clone() for a in args]
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):  # warm-up: lazily made constants, allocator
                    self.fn(*static_in)
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                # thread_local: the loader's producer thread pins host memory
                # meanwhile, which the default (global) mode counts as an
                # error of this capture.
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    static_out = self.fn(*static_in)
            self.graphs[key] = (graph, static_in, static_out)
        graph, static_in, static_out = self.graphs[key]
        for dst, src in zip(static_in, args):
            dst.copy_(src)
        graph.replay()
        return {k: v.clone() for k, v in static_out.items()}


def make_krn_eval_step(corners3d, camera_matrix, dist_coeffs, device: torch.device,
                       fp16: bool = False):
    """Returns fn(model, batch) -> dict of (B,) / (B, k) device tensors:
    q_pr, t_pr, err_q [deg], err_t [m], speed_raw, speed_mod, acc. ``batch``
    holds image (B, H, W, 3), bbox (B, 4), q_gt (B, 4), t_gt (B, 3)."""
    corners3d, camera_matrix, dist_coeffs = (
        torch.as_tensor(a, dtype=torch.float32).to(device)
        for a in (corners3d, camera_matrix, dist_coeffs))

    def pose_and_score(xc, yc, bbox, q_gt, t_gt):
        q_pr, t_pr = keypoints_to_pose(xc, yc, bbox, corners3d, camera_matrix, dist_coeffs)
        return {"q_pr": q_pr, "t_pr": t_pr, **speed_score_batched(t_pr, q_pr, t_gt, q_gt)}

    pose_and_score = CudaGraphed(pose_and_score)

    def eval_step(model, batch):
        xc, yc = _eval_forward(model, batch, fp16)
        return pose_and_score(xc.float(), yc.float(), batch["bbox"].float(),
                              batch["q_gt"].float(), batch["t_gt"].float())

    return eval_step


def _eval_forward(model, batch, fp16: bool):
    """The model's outputs on the batch, in eval mode under inference_mode
    (bf16 autocast with ``fp16``)."""
    model.eval()
    with torch.inference_mode():
        x = images_to_float(batch["image"])
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=fp16):
            return model(x)


@f32_math()
def spn_pose(weights, bbox, q_class, corners3d, camera_matrix, dist_coeffs,
             num_neighbors: int):
    """SPN pose from the weight head (B, num_classes): the top-k classes, a
    softmax over their weights, the weighted mean of their quaternions, and
    the Gauss-Newton position from ``bbox`` (B, 4). Returns q (B, 4), t (B, 3)."""
    top_w, top_c = torch.topk(weights, num_neighbors, dim=1)
    top_w = torch.softmax(top_w, dim=1)
    qs = q_class.index_select(0, top_c.reshape(-1)).reshape(*top_c.shape, 4)
    q_pr = weighted_mean_quaternion(qs, top_w)
    return q_pr, compute_position_spn_batched(q_pr, bbox, corners3d, camera_matrix,
                                              dist_coeffs)


def make_spn_eval_step(q_class, corners3d, camera_matrix, dist_coeffs, num_neighbors: int,
                       device: torch.device, fp16: bool = False):
    """Returns fn(model, batch) -> the dict of make_krn_eval_step. ``bbox``
    is the csv box (SPNDataset returns it unclamped); ``q_class`` holds the
    (num_classes, 4) attitude-class quaternions."""
    q_class, corners3d, camera_matrix, dist_coeffs = (
        torch.as_tensor(a, dtype=torch.float32).to(device)
        for a in (q_class, corners3d, camera_matrix, dist_coeffs))

    def pose_and_score(weights, bbox, q_gt, t_gt):
        q_pr, t_pr = spn_pose(weights, bbox, q_class, corners3d, camera_matrix, dist_coeffs,
                              num_neighbors)
        return {"q_pr": q_pr, "t_pr": t_pr, **speed_score_batched(t_pr, q_pr, t_gt, q_gt)}

    pose_and_score = CudaGraphed(pose_and_score)

    def eval_step(model, batch):
        _, weights = _eval_forward(model, batch, fp16)
        return pose_and_score(weights.float(), batch["bbox"].float(), batch["q_gt"].float(),
                              batch["t_gt"].float())

    return eval_step
