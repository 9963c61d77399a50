"""Dense autoencoder finetuning CLI: the port of
ip_avsr_tpu/cli/ae_finetuner.py.

Parity with */ae_finetuner.py (e.g. avletters/ae_finetuner.py:32-146): load a
pretrained unfolded AE (w1..wN/b1..bN .mat, from MATLAB or either package's
``pretrain_dbn``), finetune it on the training images with squared error +
L2 (5e-3) using adadelta or nesterov momentum, and save the finetuned AE
back to the same .mat ABI.  The AE trains on ``--device`` (default
``cuda``).

Usage:
    python -m ip_avsr_torch.cli.ae_finetuner --ae avletters_ae.mat \\
        --data allData_mouthROIs.mat --out avletters_ae_finetuned.mat
    python -m ip_avsr_torch.cli.ae_finetuner --synthetic 200 --out /tmp/ae_ft.mat --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from ip_avsr_torch.data import preprocessing as pp
from ip_avsr_torch.device import resolve_device
from ip_avsr_torch.io import matio
from ip_avsr_torch.pretrain import finetune


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ae", help="pretrained AE .mat (w1..wN/b1..bN)")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--activations",
                    default="sigmoid,sigmoid,sigmoid,linear,sigmoid,sigmoid,sigmoid,linear")
    ap.add_argument("--data", help=".mat with dataMatrix/iterVec/videoLengthVec")
    ap.add_argument("--out", required=True)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batchsize", type=int, default=128)
    ap.add_argument("--optimizer", default="adadelta", choices=["adadelta", "nesterov"])
    ap.add_argument("--learning_rate", type=float)
    ap.add_argument("--l2", type=float, default=0.005)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    acts = args.activations.split(",")
    if args.synthetic:
        rng = np.random.RandomState(0)
        dim = 24
        train_X = rng.rand(args.synthetic, dim).astype(np.float32)
        sizes = [16, 8, 16, dim]
        acts = ["sigmoid", "linear", "sigmoid", "linear"]
        weights, biases = [], []
        fan = dim
        for s in sizes:
            weights.append((0.1 * rng.randn(fan, s)).astype(np.float32))
            biases.append(np.zeros(s, np.float32))
            fan = s
    else:
        weights, biases = matio.load_dbn_mat(args.ae, n_layers=args.layers)
        data = matio.load_mat_file(args.data)
        X = data["dataMatrix"].astype(np.float32)
        vidlens = data["videoLengthVec"].reshape(-1)
        iter_vec = data["iterVec"].reshape(-1)
        split = pp.create_split_index(len(X), vidlens, iter_vec)
        train_X = pp.normalize_input(X[split].copy())

    w2, b2 = finetune.finetune_autoencoder(
        weights, biases, acts, train_X, epochs=args.epochs, batchsize=args.batchsize,
        optimizer=args.optimizer,
        learning_rate=args.learning_rate if args.learning_rate is not None
        else (0.01 if args.optimizer == "nesterov" else None),
        l2=args.l2, device=device)
    matio.save_dbn_mat(w2, b2, args.out)
    print(f"saved finetuned {len(w2)}-layer AE to {args.out}")


if __name__ == "__main__":
    main()
