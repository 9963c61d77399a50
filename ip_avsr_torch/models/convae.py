"""Convolutional autoencoder with a tied-weight decoder (AVLetters conv-AE):
the port of ip_avsr_tpu/models/convae.py.

Parity target: modelzoo/avletters_convae.py:33-69 and its batchnorm/dropout
variants (avletters_convae_bn.py, avletters_convae_drop.py:33-77,
avletters_convae_bndrop.py):

  input (B, 1, 30, 40)
   -> conv 100@5x5 valid, ScaledTanh(0.5, 2.4)   -> (100, 26, 36)
   -> maxpool 2                                  -> (100, 13, 18)
   -> conv 150@5x5 valid                         -> (150, 9, 14)
   -> maxpool 2, pad (1, 0)                      -> (150, 5, 7)
   -> conv 200@3x3 valid                         -> (200, 3, 5) = 3000
   -> dense 500 (ScaledTanh) -> bottleneck E (linear)
   -> decoder mirrors with *tied* weights: dense8 uses bottleneck.W^T,
      dense9 uses dense7.W^T, and each deconv re-uses the matching conv's
      kernel (transposed convolution); decoder biases are its own params.
  The dropout variant widens layers by 1/(1-p) (drop p=0.2 input / 0.5 hidden)
  and the bn variant wraps convs/denses in batch norm.

The JAX package runs these convolutions through XLA, not Pallas, so cuDNN
through ``F.conv2d`` is their port, as cuBLAS is the encoders': NCHW/OIHW
cross-correlation in the encoder, ``F.conv_transpose2d`` with the encoder's
own (O, I, kH, kW) kernel in the decoder (``lax.conv_transpose(...,
transpose_kernel=True)``, the weight tying), pooling with -inf padding,
upscaling by nearest repeat.  The initial parameters are drawn on the CPU
from a ``torch.Generator``; dropout masks are drawn on the input's device.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ip_avsr_torch.ops.nonlinearities import make_scaled_tanh


@dataclasses.dataclass(frozen=True)
class ConvAEConfig:
    bottleneck: int = 50
    dense: int = 500
    image_shape: tuple = (30, 40)
    use_batchnorm: bool = False
    use_dropout: bool = False
    input_dropout: float = 0.2
    hidden_dropout: float = 0.5

    def widened(self, n: int, p: float) -> int:
        return int(n / (1.0 - p)) if self.use_dropout else n

    @property
    def filters(self):
        return (
            self.widened(100, self.input_dropout),
            self.widened(150, self.hidden_dropout),
            self.widened(200, self.hidden_dropout),
        )

    @property
    def dense_mid(self):
        return self.widened(self.dense, self.hidden_dropout)

    @property
    def encode_size(self):
        return self.widened(self.bottleneck, self.hidden_dropout)

    def conv_out_shape(self):
        """Spatial dims after conv5 (static: (3, 5) for 30x40 inputs)."""
        h, w = self.image_shape
        h, w = h - 4, w - 4          # conv1 5x5 valid
        h, w = h // 2, w // 2        # pool 2
        h, w = h - 4, w - 4          # conv3 5x5 valid
        h, w = (h + 2 - 2) // 2 + 1, (w - 2) // 2 + 1  # pool 2 pad (1,0)
        h, w = h - 2, w - 2          # conv5 3x3 valid
        return h, w


def _glorot(generator, shape, fan_in, fan_out):
    lim = (6.0 / (fan_in + fan_out)) ** 0.5
    return torch.empty(shape, dtype=torch.float32).uniform_(-lim, lim, generator=generator)


def init_convae_params(generator, config: ConvAEConfig = ConvAEConfig()) -> dict:
    """Glorot-uniform kernels and dense weights, zero biases, unit/zero
    batch-norm scales and shifts, on the CPU (the JAX package's tree)."""
    f1, f2, f3 = config.filters
    ch, cw = config.conv_out_shape()
    flat = f3 * ch * cw

    def conv(shape):
        k = shape[2] * shape[3]
        return _glorot(generator, shape, shape[1] * k, shape[0] * k)

    def dense(shape):
        return _glorot(generator, shape, shape[0], shape[1])

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32)

    params = {
        "conv1": {"w": conv((f1, 1, 5, 5)), "b": zeros(f1)},
        "conv3": {"w": conv((f2, f1, 5, 5)), "b": zeros(f2)},
        "conv5": {"w": conv((f3, f2, 3, 3)), "b": zeros(f3)},
        "dense7": {"w": dense((flat, config.dense_mid)), "b": zeros(config.dense_mid)},
        "bottleneck": {"w": dense((config.dense_mid, config.encode_size)),
                       "b": zeros(config.encode_size)},
        # decoder-only biases (weights are tied to the encoder's)
        "dense8_b": zeros(config.dense_mid),
        "dense9_b": zeros(flat),
        "deconv11_b": zeros(f2),
        "deconv13_b": zeros(f1),
        "deconv15_b": zeros(1),
    }
    if config.use_batchnorm:
        for name, dim in (("conv1", f1), ("conv3", f2), ("conv5", f3),
                          ("dense7", config.dense_mid)):
            params[f"bn_{name}"] = {"gamma": torch.ones((dim,), dtype=torch.float32),
                                    "beta": zeros(dim)}
    return params


def _conv(x, w, b):
    return F.conv2d(x, w, b)


def _maxpool(x, pad_h=0):
    """2x2 max pooling, stride 2, the H axis padded by ``pad_h`` rows of
    -inf on each side (9 -> 5 rows for conv3's output)."""
    return F.max_pool2d(x, 2, 2, padding=(pad_h, 0))


def _deconv(x, w, b, crop_h=0):
    """The transposed convolution of the encoder's cross-correlation with
    its (O, I, kH, kW) kernel ("full" output), ``crop_h`` rows cropped from
    each side of H."""
    y = F.conv_transpose2d(x, w)
    if crop_h:
        y = y[:, :, crop_h:-crop_h, :]
    return y + b[None, :, None, None]


def _upscale(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _bn(x, p, eps=1e-4):
    """Batch-statistics normalization over all axes but the channel (axis 1
    of conv maps, the feature axis of 2-D dense activations), biased
    variance.  Batch statistics in every mode, as in the JAX package: this
    conv-AE exists only for pretraining, where the reference trains and
    inspects reconstructions on large batches (avletters_convae.py:290-318)."""
    axes = (0, 2, 3) if x.dim() > 2 else (0,)
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, keepdim=True, unbiased=False)
    shape = [1] * x.dim()
    shape[-1 if x.dim() == 2 else 1] = -1
    return (x - mean) / torch.sqrt(var + eps) * p["gamma"].reshape(shape) \
        + p["beta"].reshape(shape)


def _dropout(x, rate, generator, train):
    """Inverted dropout: an entry kept with probability 1 - ``rate`` is
    scaled by 1 / (1 - rate); the mask is drawn on ``x``'s device."""
    if not train or rate <= 0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def convae_encode(params, config: ConvAEConfig, x, train=False, generator=None):
    """(B, H*W) or (B, 1, H, W) -> (B, encode_size) bottleneck codes.  With
    ``train`` and a dropout config the masks come from ``generator`` (a
    generator of ``x``'s device; seeded 0 when None)."""
    act = make_scaled_tanh(0.5, 2.4)
    B = x.shape[0]
    x = x.reshape(B, 1, *config.image_shape)
    drop = config.use_dropout
    if drop and train and generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)

    if drop:
        x = _dropout(x, config.input_dropout, generator, train)
    h = _conv(x, params["conv1"]["w"], params["conv1"]["b"])
    if config.use_batchnorm:
        h = _bn(h, params["bn_conv1"])
    h = act(h)
    h = _maxpool(h)
    if drop:
        h = _dropout(h, config.hidden_dropout, generator, train)
    h = _conv(h, params["conv3"]["w"], params["conv3"]["b"])
    if config.use_batchnorm:
        h = _bn(h, params["bn_conv3"])
    h = act(h)
    h = _maxpool(h, pad_h=1)
    if drop:
        h = _dropout(h, config.hidden_dropout, generator, train)
    h = _conv(h, params["conv5"]["w"], params["conv5"]["b"])
    if config.use_batchnorm:
        h = _bn(h, params["bn_conv5"])
    h = act(h)
    h = h.reshape(B, -1)
    if drop:
        h = _dropout(h, config.hidden_dropout, generator, train)
    h = h @ params["dense7"]["w"] + params["dense7"]["b"]
    if config.use_batchnorm:
        h = _bn(h, params["bn_dense7"])
    h = act(h)
    if drop:
        h = _dropout(h, config.hidden_dropout, generator, train)
    return h @ params["bottleneck"]["w"] + params["bottleneck"]["b"]


def convae_forward(params, config: ConvAEConfig, x, train=False, generator=None):
    """The whole autoencoder: (B, H*W) reconstructions."""
    act = make_scaled_tanh(0.5, 2.4)
    B = x.shape[0]
    f1, f2, f3 = config.filters
    ch, cw = config.conv_out_shape()

    code = convae_encode(params, config, x, train, generator)
    h = code @ params["bottleneck"]["w"].T + params["dense8_b"]  # linear (tied)
    h = act(h @ params["dense7"]["w"].T + params["dense9_b"])    # tied
    h = h.reshape(B, f3, ch, cw)
    h = act(_deconv(h, params["conv5"]["w"], params["deconv11_b"]))
    h = _upscale(h)
    h = act(_deconv(h, params["conv3"]["w"], params["deconv13_b"]))
    h = _upscale(h)
    h = act(_deconv(h, params["conv1"]["w"], params["deconv15_b"], crop_h=1))
    return h.reshape(B, -1)
