"""The paper's core comparison on one dataset, on the PyTorch port: the
counterpart of ``examples/paper_mnist.py``.

HashNet vs {Equivalent-NN, Random-Edge-Removal, Low-Rank, Dark-Knowledge}
at compression 1/8 and 1/64 on the BASIC analogue (the paper's Table 1/2
columns), a 3-layer MLP of ``--hidden`` units (the paper's 1000 by
default).  Expected ordering (paper §6): at 1/64 HashNet well below every
baseline; at 1/8 HashNet ~ NN > RER > LRD.  On the card the hashed
layers run the hand-written kernels.

    PYTHONPATH=src python examples/paper_mnist_torch.py [--device cpu] \\
        [--hidden 64] [--epochs 2] [--n 3000]
"""
import argparse
import time

import torch

from repro_torch.data import mnist_synthetic as D
from repro_torch.paper import mlp, train as T


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=15)
    parser.add_argument("--n", type=int, default=3000)
    parser.add_argument("--hidden", type=int, default=1000)
    parser.add_argument("--dataset", default="basic", choices=D.DATASETS)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()

    t0 = time.perf_counter()
    x, y = D.load(args.dataset, "train", n=args.n, seed=0)
    xt, yt = D.load(args.dataset, "test", n=2000, seed=1)
    cfg = T.TrainConfig(epochs=args.epochs, distill_temp=2.0,
                        distill_alpha=0.7)
    dims = (784, args.hidden, D.num_classes(args.dataset))
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu")
    print(f"{args.dataset}: {args.n} train / {len(xt)} test, dims {dims}, "
          f"{args.epochs} epochs, on {where}")

    # compression-1 teacher for the DK variants
    tspec = mlp.MLPSpec(dims, method="dense", dropout=0.3, input_dropout=0.1)
    tparams, _ = T.fit(tspec, x, y, cfg=cfg, device=args.device)
    teacher_err = T.evaluate(tspec, tparams, xt, yt)
    print(f"teacher (compression 1): {teacher_err*100:.2f}%\n")

    print(f"{'method':12s} {'1/8':>8s} {'1/64':>8s}")
    for method in ("hashed", "hashed_dk", "nn", "dk", "rer", "lrd"):
        errs = []
        for c in (1 / 8, 1 / 64):
            r = T.run_method(method, dims, c, x, y, xt, yt, cfg,
                             teacher=(tspec, tparams), device=args.device)
            errs.append(r["test_err"])
        print(f"{method:12s} {errs[0]*100:7.2f}% {errs[1]*100:7.2f}%",
              flush=True)
    print(f"\n{time.perf_counter() - t0:.1f}s in all.  The paper's claim to "
          f"check: the hashed rows degrade far less from 1/8 -> 1/64 than "
          f"every baseline.")


if __name__ == "__main__":
    main()
