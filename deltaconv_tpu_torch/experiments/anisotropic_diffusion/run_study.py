"""Anisotropic-diffusion study runner (counterpart of
``experiments/anisotropic_diffusion/run_study.py``, the reference
notebook as a CLI, with its arguments and defaults).

Trains each operator-family ResNet to reproduce n steps of Perona-Malik
anisotropic diffusion on a test image (paper Figure 2 / supplement
Figures 2-3) and reports the final L1 error per architecture. Optionally
writes the prediction images as PNGs. Runs on the card (``--device cpu``
for the CPU)::

    python -m deltaconv_tpu_torch.experiments.anisotropic_diffusion.run_study \\
        --steps 20 --iterations 200 --save-images out/
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .architectures import ALL_NETS
from .diffusion import anisotropic_diffusion_nsteps, make_test_image

__all__ = ["main", "train_net"]


def train_net(net_cls, image, target, iterations, num_layers, width, lr,
              seed=1):
    """Trains one network from ``seed`` with Adam, weight decay 1e-5 added
    to the gradient and the learning rate divided by 10 every 50
    iterations (the notebook's ``StepLR(50, 0.1)``; optax's
    ``add_decayed_weights`` then ``adam`` in the JAX study) on the mean L1
    error; returns ``(prediction [1, H, W, C] numpy, final L1)``."""
    torch.manual_seed(seed)
    model = net_cls(num_layers=num_layers, out_channels=width,
                    in_channels=image.shape[-1]).to(image.device)
    opt = torch.optim.Adam(model.parameters(), lr=lr, weight_decay=1e-5)
    sched = torch.optim.lr_scheduler.StepLR(opt, 50, 0.1)
    for _ in range(iterations):
        loss = (model(image) - target).abs().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
    with torch.no_grad():
        pred = model(image)
        final_l1 = float((pred - target).abs().mean())
    return pred.cpu().numpy(), final_l1


def save_png(path, img):
    from PIL import Image

    arr = np.clip(np.asarray(img)[0, :, :, 0], 0, 1)
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def main(argv=None):
    """Runs the study; returns ``[(net name, final L1), ...]``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=20,
                   help="Perona-Malik diffusion steps for the target")
    p.add_argument("--iterations", type=int, default=200)
    p.add_argument("--num_layers", type=int, default=16)
    p.add_argument("--width", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--size", type=int, default=128, help="Test image size")
    p.add_argument("--save-images", type=str, default="",
                   help="Directory for input/target/prediction PNGs")
    p.add_argument("--out-jsonl", type=str, default="",
                   help="Append one JSON line per architecture")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to train on (default: cuda)")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu to run the study "
                           "on the CPU")

    image = torch.from_numpy(make_test_image(args.size)).to(args.device)
    target = anisotropic_diffusion_nsteps(image, args.steps)
    if args.save_images:
        os.makedirs(args.save_images, exist_ok=True)
        save_png(os.path.join(args.save_images, "input.png"),
                 image.cpu().numpy())
        save_png(os.path.join(args.save_images, "target.png"),
                 target.cpu().numpy())

    print(f"Perona-Malik target: {args.steps} steps; training "
          f"{args.iterations} iterations per net\n")
    results = []
    for net_cls in ALL_NETS:
        pred, l1 = train_net(net_cls, image, target, args.iterations,
                             args.num_layers, args.width, args.lr)
        results.append((net_cls.net_name(), l1))
        print(f"{net_cls.net_name():<14s} final L1 = {l1:.5f}", flush=True)
        if args.out_jsonl:
            with open(args.out_jsonl, "a") as f:
                f.write(json.dumps({
                    "net": net_cls.net_name(), "final_l1": round(l1, 6),
                    "steps": args.steps, "iterations": args.iterations,
                    "num_layers": args.num_layers, "width": args.width,
                    "lr": args.lr, "size": args.size,
                    "device": args.device}) + "\n")
        if args.save_images:
            fn = net_cls.net_name().replace("+", "p").lower() + ".png"
            save_png(os.path.join(args.save_images, fn), pred)
    best = min(results, key=lambda r: r[1])
    print(f"\nBest fit: {best[0]} (L1 {best[1]:.5f})")
    return results


if __name__ == "__main__":
    main()
