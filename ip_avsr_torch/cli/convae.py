"""Conv-autoencoder pretraining CLI: the port of ip_avsr_tpu/cli/convae.py.

Parity with avletters/avletters_convae.py:202-330: load mouth-ROI images
(`.mat` schema with iterVec train/test split), resize 60x80 -> 30x40,
samplewise normalize, train one of the four conv-AE variants
(--model plain|batchnorm|dropout|bndrop) with adadelta (lr 0.8, decay 0.9
after epoch 10), SIGINT-graceful stop, then pickle the parameters as numpy
arrays (the JAX package's format: either package reads the file).  The
conv-AE trains on ``--device`` (default ``cuda``).

Usage:
    python -m ip_avsr_torch.cli.convae --data allData_mouthROIs.mat --model batchnorm
    python -m ip_avsr_torch.cli.convae --synthetic 64 --model plain --epochs 2 --device cpu
"""

from __future__ import annotations

import argparse
import signal

import numpy as np

from ip_avsr_torch.data import preprocessing as pp
from ip_avsr_torch.device import resolve_device, tree_map
from ip_avsr_torch.io import matio
from ip_avsr_torch.models.convae import ConvAEConfig
from ip_avsr_torch.pretrain.finetune import train_convae


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", help=".mat with dataMatrix/iterVec/videoLengthVec")
    ap.add_argument("--model", default="plain",
                    choices=["plain", "batchnorm", "dropout", "bndrop"])
    ap.add_argument("--out", default="convae_encoder.pkl")
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--batchsize", type=int, default=128)
    ap.add_argument("--learning_rate", type=float, default=0.8)
    ap.add_argument("--bottleneck", type=int, default=50)
    ap.add_argument("--dense", type=int, default=500)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.synthetic:
        rng = np.random.RandomState(0)
        protos = rng.rand(4, 1200).astype(np.float32)
        train_X = protos[rng.randint(0, 4, args.synthetic)] + \
            0.05 * rng.randn(args.synthetic, 1200).astype(np.float32)
        train_X = pp.normalize_input(train_X)
    else:
        data = matio.load_mat_file(args.data)
        X = data["dataMatrix"].astype(np.float32)
        vidlens = data["videoLengthVec"].reshape(-1)
        iter_vec = data["iterVec"].reshape(-1)
        split = pp.create_split_index(len(X), vidlens, iter_vec)
        train_X = X[split]
        if train_X.shape[1] != 1200:  # 60x80 -> 30x40 (avletters_convae.py:151-157)
            train_X = pp.resize_images(train_X, orig_dim=(60, 80), dim=(30, 40))
        train_X = pp.normalize_input(train_X.astype(np.float32))

    cfg = ConvAEConfig(
        bottleneck=args.bottleneck,
        dense=args.dense,
        use_batchnorm=args.model in ("batchnorm", "bndrop"),
        use_dropout=args.model in ("dropout", "bndrop"),
    )

    stop = {"flag": False}

    def on_sigint(signum, frame):  # graceful stop (avletters_convae.py:204-209)
        print("stop requested, finishing current epoch...")
        stop["flag"] = True

    old = signal.signal(signal.SIGINT, on_sigint)
    try:
        params, history = train_convae(
            train_X, cfg, epochs=args.epochs, batchsize=args.batchsize,
            learning_rate=args.learning_rate, stop_flag=lambda: stop["flag"], device=device)
    finally:
        signal.signal(signal.SIGINT, old)

    matio.save_model({"config": cfg.__dict__,
                      "params": tree_map(lambda v: v.detach().cpu().numpy(), params),
                      "history": history}, args.out)
    print(f"saved conv-AE ({args.model}) to {args.out}; final loss {history[-1]:.6f}")


if __name__ == "__main__":
    main()
