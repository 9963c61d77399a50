"""DBN/RBM pretraining CLI: the port of ip_avsr_tpu/cli/pretrain_dbn.py.

Parity with dbn/exampleDBN_AE.m:40-53: normalize data, greedy-train the RBM
stack, unfold to an autoencoder (or classifier), optionally finetune on
reconstruction, and export the w1..wN/b1..bN ``.mat`` checkpoint
(dbn/extractNN.m ABI) that the training runners of either package read.
The data is read and normalised on the host; the RBMs train on ``--device``
(default ``cuda``; ``cpu`` runs the same PyTorch code on the CPU).

Usage:
    python -m ip_avsr_torch.cli.pretrain_dbn --data features.mat --out ae.mat \\
        --hidden 2000,1000,500,50 --activations sigm,sigm,sigm,linear
    python -m ip_avsr_torch.cli.pretrain_dbn --synthetic 500 --input-dim 64 \\
        --hidden 32,16,8 --activations sigm,sigm,linear --out /tmp/ae.mat --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from ip_avsr_torch.device import resolve_device
from ip_avsr_torch.io import matio
from ip_avsr_torch.pretrain import dbn as dbn_lib
from ip_avsr_torch.pretrain import finetune, rbm, unfold


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", help=".mat file with dataMatrix (frames x features)")
    ap.add_argument("--field", default="dataMatrix")
    ap.add_argument("--out", required=True, help="output .mat (w1..wN/b1..bN)")
    ap.add_argument("--hidden", default="2000,1000,500,50")
    ap.add_argument("--activations", default="sigm,sigm,sigm,linear")
    ap.add_argument("--input-activation", default="sigm")
    ap.add_argument("--dbn-type", type=int, default=1, help="1=AE, 2=classifier")
    ap.add_argument("--output-classes", type=int, default=26, help="for --dbn-type 2")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batchsize", type=int, default=100)
    ap.add_argument("--cd-type", type=int, default=1)
    ap.add_argument("--finetune-epochs", type=int, default=0,
                    help="reconstruction finetuning after unfolding (AE only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="use N synthetic rows instead of --data")
    ap.add_argument("--input-dim", type=int, default=64, help="with --synthetic")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    hidden = [int(h) for h in args.hidden.split(",")]
    acts = args.activations.split(",")

    if args.synthetic:
        rng = np.random.RandomState(args.seed)
        protos = rng.rand(8, args.input_dim)
        data = (protos[rng.randint(0, 8, args.synthetic)]
                + 0.05 * rng.randn(args.synthetic, args.input_dim))
        data = np.clip(data, 0, 1).astype(np.float32)
    else:
        data = matio.load_mat_file(args.data)[args.field].astype(np.float32)

    data, _ = rbm.normalise_data(args.input_activation, data)
    hyper = rbm.RBMHyperParams(epochs=args.epochs, batchsize=args.batchsize,
                               cd_type=args.cd_type)
    d = dbn_lib.train_dbn(args.seed, data, hidden, acts,
                          input_activation=args.input_activation, hyper=hyper, device=device)
    nn = unfold.unfold_dbn_to_nn(
        d, args.dbn_type, hidden, acts, args.input_activation,
        output_size=data.shape[1] if args.dbn_type == 1 else args.output_classes,
        rng=np.random.RandomState(args.seed))

    if args.finetune_epochs and args.dbn_type == 1:
        weights, biases = finetune.finetune_autoencoder(
            nn["W"], nn["biases"], nn["activationFunctions"], data,
            epochs=args.finetune_epochs, device=device)
        nn["W"], nn["biases"] = weights, biases

    matio.save_mat(unfold.extract_nn(nn), args.out)
    print(f"saved {len(nn['W'])}-layer {'AE' if args.dbn_type == 1 else 'classifier'} "
          f"to {args.out}")


if __name__ == "__main__":
    main()
