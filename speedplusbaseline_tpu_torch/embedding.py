"""Style-embedding statistics CLI: ``python -m speedplusbaseline_tpu_torch.embedding``.

The counterpart of ``scripts/get_embedding_mean_and_covariance.py``
(reference src/styleaug/get_embedding_mean_and_covariance.py:25-81), flag
for flag, plus ``--no_cuda``. Runs the StylePredictor over every
.jpg/.jpeg/.png under ``--data_dir`` (a recursive walk, files sorted per
directory), each image read as ``Image.open(p).convert("RGB").resize((w,
h))``, in batches of ``--batchsize``; the last ``len % batchsize`` images
are dropped, as the script drops them. Writes to ``--out_dir``:

  embeddings_speedplus.npy               (N, 100) float32
  style_embedding_speedplus_mean.npy     (100,)
  embedding_covariance_speedplus.npy     (100, 100), np.cov(rowvar=False)

``--checkpoint`` takes the JAX package's converted ``.msgpack`` (scripts/
convert_style_predictor.py, or ``convert_weights style_predictor``) or the
reference's torch ``checkpoint_stylepredictor.pth``. Runs on CUDA unless
``--no_cuda`` is given, in f32 with TF32 off; with no GPU and no
``--no_cuda`` it raises.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .config import full_f32, resolve_device
from .convert import flax_to_state_dict, read_flax_msgpack
from .models.style_predictor import EMBED_DIM, StylePredictor
from .models.weight_convert import convert_style_predictor


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("Style-embedding mean and covariance")
    ap.add_argument("--data_dir", required=True,
                    help="Directory of style images (searched recursively)")
    ap.add_argument("--batchsize", type=int, default=8)
    ap.add_argument("--input_size", type=int, nargs=2, default=(320, 480),
                    help="H W to resize images to")
    ap.add_argument("--checkpoint", type=str, default="",
                    help="StylePredictor weights (.msgpack or .pth)")
    ap.add_argument("--allow_random_init", action="store_true")
    ap.add_argument("--out_dir", type=str, default="assets")
    ap.add_argument("--no_cuda", dest="use_cuda", action="store_false", default=True)
    ap.set_defaults(gpu_id=0)  # resolve_device's card; no flag
    return ap


def image_paths(data_dir: str):
    paths = []
    for root, _, files in os.walk(data_dir):
        for f in sorted(files):
            if f.lower().endswith((".jpg", ".jpeg", ".png")):
                paths.append(os.path.join(root, f))
    return paths


def load_style_predictor(path: str) -> dict:
    """A ``StylePredictor`` state_dict from a flax ``.msgpack``
    ({"params", "batch_stats"}) or a torch ``.pth`` (its
    ``state_dict_stylepredictor`` entry, or the state_dict itself)."""
    if path.endswith(".msgpack"):
        raw = read_flax_msgpack(path)
        return flax_to_state_dict(raw["params"], raw["batch_stats"])
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return convert_style_predictor(ckpt.get("state_dict_stylepredictor", ckpt))


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    """Write the three files; returns the (N, 100) embeddings."""
    from PIL import Image

    args = build_parser().parse_args(argv)
    device = resolve_device(args)
    full_f32()

    paths = image_paths(args.data_dir)
    if not paths:
        raise SystemExit(f"no images under {args.data_dir}")
    print(f"{len(paths)} images")

    torch.manual_seed(0)  # the random init of --allow_random_init
    model = StylePredictor()
    if args.checkpoint:
        model.load_state_dict(load_style_predictor(args.checkpoint))
    elif not args.allow_random_init:
        raise SystemExit("no --checkpoint given (use --allow_random_init to "
                         "run the pipeline with random weights)")
    model = model.to(device).eval()

    h, w = args.input_size
    bs = args.batchsize
    n = len(paths) - len(paths) % bs
    out = np.zeros((n, EMBED_DIM), np.float32)
    with torch.inference_mode():
        for i in range(0, n, bs):
            imgs = [np.asarray(Image.open(p).convert("RGB").resize((w, h)))
                    for p in paths[i:i + bs]]
            batch = torch.from_numpy(np.stack(imgs)).to(device).permute(0, 3, 1, 2)
            out[i:i + bs] = model(batch.float() / 255.0).cpu().numpy()
            if (i // bs) % 20 == 0:
                print(f"{i}/{len(paths)}")

    mean = out.mean(axis=0)
    sigma = np.cov(out, rowvar=False)
    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir, "embeddings_speedplus.npy"), out)
    np.save(os.path.join(args.out_dir, "style_embedding_speedplus_mean.npy"), mean)
    np.save(os.path.join(args.out_dir, "embedding_covariance_speedplus.npy"), sigma)
    print("saved mean/cov to", args.out_dir)
    return out


if __name__ == "__main__":
    main()
