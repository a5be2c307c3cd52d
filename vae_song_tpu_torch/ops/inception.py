"""InceptionV3 pool3 feature extractor (port of vae_song_tpu/ops/inception.py)
for Inception-comparable FID scores from weights given on disk.

The weights are a torchvision `inception_v3` state dict, as a `.npz` of
its names ("Conv2d_1a_3x3.conv.weight", "Mixed_5b.branch1x1.bn.running_mean",
...) or a torch `.pt`/`.pth`; none is in the repository and none is
fetched. The graph is torchvision's (BasicConv2d = bias-free conv +
BatchNorm(eps=1e-3), folded here into a per-channel scale and shift, +
ReLU; Mixed_5b..7c; the global average pool to 2048 features) with
pytorch_fid's one change, `count_include_pad=False` in the in-block
average pools, and pytorch_fid's input pipeline: grayscale broadcast to
3 channels, a bilinear resize to 299 x 299 (half-pixel centres, no
antialias), then [0, 1] mapped to [-1, 1]. On the card the convolutions
run in IEEE f32 (cuDNN TF32 off).
"""

import numpy as np
import torch
import torch.nn.functional as F

from vae_song_tpu_torch.nn.blocks import _ieee_f32


def load_state_dict(path):
    """{torchvision name: numpy array} from a .npz or a torch checkpoint."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


_A_CONVS = ("branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1",
            "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool")
_B_CONVS = ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3")
_C_CONVS = ("branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
            "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
            "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool")
_D_CONVS = ("branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2",
            "branch7x7x3_3", "branch7x7x3_4")
_E_CONVS = ("branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
            "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
            "branch3x3dbl_3b", "branch_pool")
_STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1", "Conv2d_4a_3x3")
_BLOCKS = {"Mixed_5b": ("a", _A_CONVS), "Mixed_5c": ("a", _A_CONVS),
           "Mixed_5d": ("a", _A_CONVS), "Mixed_6a": ("b", _B_CONVS),
           "Mixed_6b": ("c", _C_CONVS), "Mixed_6c": ("c", _C_CONVS),
           "Mixed_6d": ("c", _C_CONVS), "Mixed_6e": ("c", _C_CONVS),
           "Mixed_7a": ("d", _D_CONVS), "Mixed_7b": ("e", _E_CONVS),
           "Mixed_7c": ("e", _E_CONVS)}
_P17, _P71 = (0, 3), (3, 0)   # (h, w) padding of the 1x7 and 7x1 convolutions


class InceptionV3Features(torch.nn.Module):
    """pool3 (2048-d) InceptionV3 features of [B, H, W, C] or [B, H, W]
    images in [0, 1]:

        extractor = InceptionV3Features(weights_path, device="cuda")
        feats = extractor(images)     # [B, 2048] float32

    `state_dict` (torchvision names to arrays) may stand in for the path."""

    def __init__(self, weights_path=None, device="cuda", state_dict=None):
        super().__init__()
        sd = state_dict if state_dict is not None else load_state_dict(weights_path)
        self._convs = {}
        for name in _STEM:
            self._basic_conv(sd, name)
        for blk, (_, convs) in _BLOCKS.items():
            for c in convs:
                self._basic_conv(sd, f"{blk}.{c}")
        self.to(device)

    def _basic_conv(self, sd, prefix):
        """BasicConv2d: the OIHW weight and the BatchNorm folded into a
        per-channel scale and shift (eps 1e-3)."""
        gamma = np.asarray(sd[f"{prefix}.bn.weight"], np.float32)
        beta = np.asarray(sd[f"{prefix}.bn.bias"], np.float32)
        mean = np.asarray(sd[f"{prefix}.bn.running_mean"], np.float32)
        var = np.asarray(sd[f"{prefix}.bn.running_var"], np.float32)
        scale = gamma / np.sqrt(var + 1e-3)
        shift = beta - mean * scale
        key = prefix.replace(".", "__")
        self.register_buffer(f"{key}__w", torch.from_numpy(
            np.asarray(sd[f"{prefix}.conv.weight"], np.float32).copy()))
        self.register_buffer(f"{key}__scale", torch.from_numpy(scale[:, None, None].copy()))
        self.register_buffer(f"{key}__shift", torch.from_numpy(shift[:, None, None].copy()))

    def _conv(self, x, prefix, stride=1, padding=(0, 0)):
        key = prefix.replace(".", "__")
        y = F.conv2d(x, getattr(self, f"{key}__w"), stride=stride, padding=padding)
        return F.relu(y * getattr(self, f"{key}__scale") + getattr(self, f"{key}__shift"))

    def forward(self, images):
        x = images.to(torch.float32)
        if x.dim() == 3:
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)
        if x.shape[1] == 1:
            x = x.expand(-1, 3, -1, -1)
        x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                          antialias=False)
        x = x * 2.0 - 1.0               # pytorch_fid's [-1, 1]
        with _ieee_f32(x):
            c = self._conv
            x = c(x, "Conv2d_1a_3x3", stride=2)
            x = c(x, "Conv2d_2a_3x3")
            x = c(x, "Conv2d_2b_3x3", padding=(1, 1))
            x = F.max_pool2d(x, 3, 2)
            x = c(x, "Conv2d_3b_1x1")
            x = c(x, "Conv2d_4a_3x3")
            x = F.max_pool2d(x, 3, 2)
            for blk, (kind, _) in _BLOCKS.items():
                x = getattr(self, f"_block_{kind}")(x, blk)
        return x.mean(dim=(2, 3))

    @staticmethod
    def _avg_pool(x):
        return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)

    def _block_a(self, x, p):
        c = self._conv
        b1 = c(x, f"{p}.branch1x1")
        b5 = c(c(x, f"{p}.branch5x5_1"), f"{p}.branch5x5_2", padding=(2, 2))
        b3 = c(c(c(x, f"{p}.branch3x3dbl_1"), f"{p}.branch3x3dbl_2", padding=(1, 1)),
               f"{p}.branch3x3dbl_3", padding=(1, 1))
        bp = c(self._avg_pool(x), f"{p}.branch_pool")
        return torch.cat([b1, b5, b3, bp], dim=1)

    def _block_b(self, x, p):
        c = self._conv
        b3 = c(x, f"{p}.branch3x3", stride=2)
        bd = c(c(c(x, f"{p}.branch3x3dbl_1"), f"{p}.branch3x3dbl_2", padding=(1, 1)),
               f"{p}.branch3x3dbl_3", stride=2)
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], dim=1)

    def _block_c(self, x, p):
        c = self._conv
        b1 = c(x, f"{p}.branch1x1")
        b7 = c(c(c(x, f"{p}.branch7x7_1"), f"{p}.branch7x7_2", padding=_P17),
               f"{p}.branch7x7_3", padding=_P71)
        bd = x
        for name, pad in (("branch7x7dbl_1", (0, 0)), ("branch7x7dbl_2", _P71),
                          ("branch7x7dbl_3", _P17), ("branch7x7dbl_4", _P71),
                          ("branch7x7dbl_5", _P17)):
            bd = c(bd, f"{p}.{name}", padding=pad)
        bp = c(self._avg_pool(x), f"{p}.branch_pool")
        return torch.cat([b1, b7, bd, bp], dim=1)

    def _block_d(self, x, p):
        c = self._conv
        b3 = c(c(x, f"{p}.branch3x3_1"), f"{p}.branch3x3_2", stride=2)
        b7 = c(c(c(x, f"{p}.branch7x7x3_1"), f"{p}.branch7x7x3_2", padding=_P17),
               f"{p}.branch7x7x3_3", padding=_P71)
        b7 = c(b7, f"{p}.branch7x7x3_4", stride=2)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)

    def _block_e(self, x, p):
        c = self._conv
        b1 = c(x, f"{p}.branch1x1")
        b3 = c(x, f"{p}.branch3x3_1")
        b3 = torch.cat([c(b3, f"{p}.branch3x3_2a", padding=(0, 1)),
                        c(b3, f"{p}.branch3x3_2b", padding=(1, 0))], dim=1)
        bd = c(c(x, f"{p}.branch3x3dbl_1"), f"{p}.branch3x3dbl_2", padding=(1, 1))
        bd = torch.cat([c(bd, f"{p}.branch3x3dbl_3a", padding=(0, 1)),
                        c(bd, f"{p}.branch3x3dbl_3b", padding=(1, 0))], dim=1)
        bp = c(self._avg_pool(x), f"{p}.branch_pool")
        return torch.cat([b1, b3, bd, bp], dim=1)


def synthetic_state_dict(rng=None):
    """Shape-correct random torchvision-named state dict, not real
    Inception weights: the JAX package's test fixture, the same numpy
    draws from `default_rng(0)`."""
    rng = rng or np.random.default_rng(0)
    sd = {}

    def bc(prefix, cin, cout, kh, kw):
        sd[f"{prefix}.conv.weight"] = rng.normal(
            scale=0.05, size=(cout, cin, kh, kw)).astype(np.float32)
        sd[f"{prefix}.bn.weight"] = np.ones(cout, np.float32)
        sd[f"{prefix}.bn.bias"] = np.zeros(cout, np.float32)
        sd[f"{prefix}.bn.running_mean"] = np.zeros(cout, np.float32)
        sd[f"{prefix}.bn.running_var"] = np.ones(cout, np.float32)

    bc("Conv2d_1a_3x3", 3, 32, 3, 3)
    bc("Conv2d_2a_3x3", 32, 32, 3, 3)
    bc("Conv2d_2b_3x3", 32, 64, 3, 3)
    bc("Conv2d_3b_1x1", 64, 80, 1, 1)
    bc("Conv2d_4a_3x3", 80, 192, 3, 3)

    def block_a(name, cin, pool_features):
        bc(f"{name}.branch1x1", cin, 64, 1, 1)
        bc(f"{name}.branch5x5_1", cin, 48, 1, 1)
        bc(f"{name}.branch5x5_2", 48, 64, 5, 5)
        bc(f"{name}.branch3x3dbl_1", cin, 64, 1, 1)
        bc(f"{name}.branch3x3dbl_2", 64, 96, 3, 3)
        bc(f"{name}.branch3x3dbl_3", 96, 96, 3, 3)
        bc(f"{name}.branch_pool", cin, pool_features, 1, 1)
        return 64 + 64 + 96 + pool_features

    def block_b(name, cin):
        bc(f"{name}.branch3x3", cin, 384, 3, 3)
        bc(f"{name}.branch3x3dbl_1", cin, 64, 1, 1)
        bc(f"{name}.branch3x3dbl_2", 64, 96, 3, 3)
        bc(f"{name}.branch3x3dbl_3", 96, 96, 3, 3)
        return 384 + 96 + cin

    def block_c(name, cin, c7):
        bc(f"{name}.branch1x1", cin, 192, 1, 1)
        bc(f"{name}.branch7x7_1", cin, c7, 1, 1)
        bc(f"{name}.branch7x7_2", c7, c7, 1, 7)
        bc(f"{name}.branch7x7_3", c7, 192, 7, 1)
        bc(f"{name}.branch7x7dbl_1", cin, c7, 1, 1)
        bc(f"{name}.branch7x7dbl_2", c7, c7, 7, 1)
        bc(f"{name}.branch7x7dbl_3", c7, c7, 1, 7)
        bc(f"{name}.branch7x7dbl_4", c7, c7, 7, 1)
        bc(f"{name}.branch7x7dbl_5", c7, 192, 1, 7)
        bc(f"{name}.branch_pool", cin, 192, 1, 1)
        return 192 * 4

    def block_d(name, cin):
        bc(f"{name}.branch3x3_1", cin, 192, 1, 1)
        bc(f"{name}.branch3x3_2", 192, 320, 3, 3)
        bc(f"{name}.branch7x7x3_1", cin, 192, 1, 1)
        bc(f"{name}.branch7x7x3_2", 192, 192, 1, 7)
        bc(f"{name}.branch7x7x3_3", 192, 192, 7, 1)
        bc(f"{name}.branch7x7x3_4", 192, 192, 3, 3)
        return 320 + 192 + cin

    def block_e(name, cin):
        bc(f"{name}.branch1x1", cin, 320, 1, 1)
        bc(f"{name}.branch3x3_1", cin, 384, 1, 1)
        bc(f"{name}.branch3x3_2a", 384, 384, 1, 3)
        bc(f"{name}.branch3x3_2b", 384, 384, 3, 1)
        bc(f"{name}.branch3x3dbl_1", cin, 448, 1, 1)
        bc(f"{name}.branch3x3dbl_2", 448, 384, 3, 3)
        bc(f"{name}.branch3x3dbl_3a", 384, 384, 1, 3)
        bc(f"{name}.branch3x3dbl_3b", 384, 384, 3, 1)
        bc(f"{name}.branch_pool", cin, 192, 1, 1)
        return 320 + 768 + 768 + 192

    c = block_a("Mixed_5b", 192, 32)
    c = block_a("Mixed_5c", c, 64)
    c = block_a("Mixed_5d", c, 64)
    c = block_b("Mixed_6a", c)
    c = block_c("Mixed_6b", c, 128)
    c = block_c("Mixed_6c", c, 160)
    c = block_c("Mixed_6d", c, 160)
    c = block_c("Mixed_6e", c, 192)
    c = block_d("Mixed_7a", c)
    c = block_e("Mixed_7b", c)
    c = block_e("Mixed_7c", c)
    assert c == 2048, c
    return sd
