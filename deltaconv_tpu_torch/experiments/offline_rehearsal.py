"""Offline rehearsal of the pretrained-evaluation replication path with
the port (its leg of ``replication_scripts/offline_rehearsal.py``).

The real replication needs network access for the datasets and the
upstream release ``.pt`` weights. This rehearsal runs the same code path
end to end with none:

1. it writes a tiny ModelNet10 raw tree (OFF meshes) under a temporary
   data root, so the dataset pipeline (NormalizeScale -> SamplePoints ->
   GeodesicFPS) runs for real;
2. it ``torch.save``s the port model's own ``state_dict`` (the upstream
   release's key layout) for the CLI's model as ``modelnet10.pt``;
3. it runs ``train_modelnet.main(["--checkpoint", <pt>, ...])``, the
   command of ``replication_scripts/pretrained/modelnet40.sh``, which
   loads the ``.pt`` strictly (``restore_any``) and evaluates;
4. the same for segmentation: a ShapeNet-part raw tree, a release-layout
   checkpoint of ``test_shapenet``'s model, and its voting evaluation
   (2 votes here).

It prints ``offline rehearsal: OK`` and exits 0 when both legs evaluate.
On the card by default (``--device cpu`` for the CPU)::

    python -m deltaconv_tpu_torch.experiments.offline_rehearsal
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

# A tiny but real configuration (the CLI tests' sizes).
NUM_POINTS = 32
K = 8
BATCH = 4


def make_modelnet_fixture(root: str, rng) -> None:
    """A 2-category ModelNet10-layout raw tree of random OFF meshes."""
    raw = os.path.join(root, "raw")
    for cat in ("chair", "table"):
        for split, count in (("train", 6), ("test", 4)):
            d = os.path.join(raw, cat, split)
            os.makedirs(d, exist_ok=True)
            for i in range(count):
                v = rng.random((30, 3))
                f = rng.integers(0, 30, (20, 3))
                with open(os.path.join(d, f"{cat}_{i:04d}.off"), "w") as fh:
                    fh.write("OFF\n30 20 0\n")
                    for row in v:
                        fh.write(" ".join(map(str, row)) + "\n")
                    for row in f:
                        fh.write("3 " + " ".join(map(str, row)) + "\n")
    # The marker that skips the dataset's download step.
    open(os.path.join(raw, ".extracted"), "w").close()


def make_shapenet_fixture(root: str, rng) -> None:
    """A 2-category ShapeNet-part-layout raw tree (xyz + normal + label
    text files and the shuffled split lists)."""
    raw = os.path.join(root, "raw")
    names = []
    for cid in ("02691156", "02773838"):  # Airplane, Bag
        os.makedirs(os.path.join(raw, cid), exist_ok=True)
        for i in range(4):
            n = 2 * NUM_POINTS
            nrm = rng.standard_normal((n, 3))
            nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
            arr = np.concatenate(
                [rng.random((n, 3)), nrm,
                 rng.integers(0, 4, (n, 1)).astype(float)], axis=1)
            np.savetxt(os.path.join(raw, cid, f"model{i}.txt"), arr)
            names.append(f"shape_data/{cid}/model{i}")
    split_dir = os.path.join(raw, "train_test_split")
    os.makedirs(split_dir, exist_ok=True)
    for split, sel in (("train", names[:4]), ("val", names[4:5]),
                       ("test", names[5:])):
        with open(os.path.join(split_dir,
                               f"shuffled_{split}_file_list.json"), "w") as f:
            json.dump(sel, f)
    open(os.path.join(raw, ".extracted"), "w").close()


def _release(model, path: str) -> None:
    """``torch.save`` of ``model``'s ``state_dict`` on the CPU: the
    release files' form."""
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)


def _common_flags(data_root, logdir, device):
    return ["--num_points", str(NUM_POINTS), "--k", str(K), "--batch_size",
            str(BATCH), "--data_root", data_root, "--logdir", logdir,
            "--operator_dtype", "float32", "--no_data_parallel",
            "--device", device, "--seed", "1"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to evaluate on (default: cuda)")
    args = p.parse_args(argv)
    from . import test_shapenet, train_modelnet, train_shapenet

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        data_root = os.path.join(tmp, "ModelNet10")
        make_modelnet_fixture(data_root, rng)
        flags = ["--num_classes", "10", "--sampling_margin", "2",
                 *_common_flags(data_root, os.path.join(tmp, "logs"),
                                args.device)]
        # The checkpoint holds weights of another seed than the CLI's
        # model draws, so its evaluation reads the file's.
        cli = train_modelnet.build_parser().parse_args(flags)
        cli.seed = 0
        ckpt = os.path.join(tmp, "modelnet10.pt")
        _release(train_modelnet.build_model(cli), ckpt)
        _, scalars = train_modelnet.main(["--checkpoint", ckpt, *flags])
        if not np.isfinite(scalars["test accuracy"]):
            print("offline rehearsal: eval produced no accuracy")
            return 1
        print("offline rehearsal: .pt load + eval path exercised")

        seg_root = os.path.join(tmp, "ShapeNet")
        make_shapenet_fixture(seg_root, rng)
        seg_flags = ["--num_votes", "2",
                     *_common_flags(seg_root, os.path.join(tmp, "seg_logs"),
                                    args.device)]
        cli = test_shapenet.build_parser().parse_args(seg_flags)
        cli.seed = 0
        seg_ckpt = os.path.join(tmp, "shapenet.pt")
        _release(train_shapenet.shapenet_model(cli, 50), seg_ckpt)
        _, scalars = test_shapenet.main(["--checkpoint", seg_ckpt,
                                         *seg_flags])
        if not np.isfinite(scalars["test mIoU"]):
            print("offline rehearsal (seg voting): no mIoU")
            return 1
        print("offline rehearsal: seg .pt load + voting eval path "
              "exercised")
    print("offline rehearsal: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
