"""The frozen CLIP image encoder: a ViT visual tower as ``nn.Module``s.

Counterpart of ``unet_implementations_tpu/models/clip.py``. The CLIP_UNet
recipe uses only the tower's global image embedding, (B, output_dim),
broadcast over the UNet's bottleneck grid (``models/unet.py``,
``clip_fusion``).

The modules own the OpenAI CLIP visual tower's state-dict keys without the
``visual.`` prefix (``conv1.weight``, ``class_embedding``,
``positional_embedding``, ``ln_pre``, ``transformer.resblocks.{i}.{ln_1,
attn.in_proj_weight, attn.in_proj_bias, attn.out_proj, ln_2, mlp.c_fc,
mlp.c_proj}``, ``ln_post``, ``proj``), so a published checkpoint loads with
``load_state_dict(strict=True)`` (``load_torch_clip_weights``).

The numerics are the Flax tower's: parameters are float32; the LayerNorms
run in float32 (eps 1e-5) and the residual stream stays float32; the patch
conv, the products and the attention (scores and softmax written out, q
divided by sqrt(head_dim)) run in the compute dtype; the class token and
positional embedding are added in the compute dtype; ``ln_post`` takes
token 0 and its projection runs in float32. The attention is plain torch:
it was XLA in JAX, so there is no kernel to port.

No pretrained weights are reachable offline: without ``weights_path`` the
tower runs on random weights drawn from an explicit seed.
"""

from __future__ import annotations

import dataclasses
import math
import zipfile
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.ops.normalize import normalize_image
from unet_implementations_tpu_torch.ops.resize import resize_bilinear

LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: int = 512

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


CLIP_CONFIGS: Dict[str, CLIPVisionConfig] = {
    "ViT-B/16": CLIPVisionConfig(patch_size=16, width=768, layers=12, heads=12, output_dim=512),
    "ViT-B/32": CLIPVisionConfig(patch_size=32, width=768, layers=12, heads=12, output_dim=512),
    "ViT-L/14": CLIPVisionConfig(patch_size=14, width=1024, layers=24, heads=16, output_dim=768),
}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 * x)."""
    return x * torch.sigmoid(1.702 * x)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` in ``dtype``: input, weight and bias cast at the call."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """``ln`` in float32 on a float32 copy of x; the output is float32."""
    return F.layer_norm(x.to(torch.float32), ln.normalized_shape, ln.weight, ln.bias, ln.eps)


def _normal(shape, std: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).normal_(0.0, std, generator=generator))


class Attention(nn.Module):
    """Multi-head self-attention with ``nn.MultiheadAttention``'s parameter
    names (the OpenAI tower's ``attn``): the q/k/v projections stacked in
    ``in_proj_weight`` (3W, W) and ``in_proj_bias``, then ``out_proj``."""

    def __init__(self, width: int, heads: int, generator: torch.Generator):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = _normal((3 * width, width), width ** -0.5, generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        with torch.no_grad():
            self.out_proj.weight.normal_(0.0, width ** -0.5, generator=generator)
            self.out_proj.bias.zero_()

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, n, width = x.shape
        hd = width // self.heads
        qkv = F.linear(x.to(dtype), self.in_proj_weight.to(dtype), self.in_proj_bias.to(dtype))
        q, k, v = (t.reshape(b, n, self.heads, hd).transpose(1, 2)
                   for t in qkv.split(width, dim=-1))
        q = q / torch.tensor(math.sqrt(hd), dtype=dtype, device=x.device)
        weights = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, n, width)
        return _linear(out, self.out_proj, dtype)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block: x + attn(ln_1(x)), then x + mlp(ln_2(x))
    with QuickGELU; the residual stream stays float32."""

    def __init__(self, width: int, heads: int, generator: torch.Generator, layers: int):
        super().__init__()
        self.attn = Attention(width, heads, generator)
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(width, 4 * width),
                                  "c_proj": nn.Linear(4 * width, width)})
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)
        with torch.no_grad():
            # OpenAI CLIP's initialization of the visual tower.
            self.mlp.c_fc.weight.normal_(0.0, (2 * width) ** -0.5, generator=generator)
            self.mlp.c_proj.weight.normal_(0.0, width ** -0.5 * (2 * layers) ** -0.5,
                                           generator=generator)
            self.mlp.c_fc.bias.zero_()
            self.mlp.c_proj.bias.zero_()

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x + self.attn(_layer_norm(x, self.ln_1), dtype)
        y = quick_gelu(_linear(_layer_norm(x, self.ln_2), self.mlp.c_fc, dtype))
        return x + _linear(y, self.mlp.c_proj, dtype)


class CLIPVisionTransformer(nn.Module):
    """NHWC images (B, image_size, image_size, 3) -> float32 global
    embeddings (B, output_dim). ``dtype`` is the compute dtype; every
    parameter is float32. Built on the CPU from ``generator`` (a fresh
    seed-0 generator when None); move it with ``.to(device)``."""

    def __init__(self, config: CLIPVisionConfig = CLIP_CONFIGS["ViT-B/16"],
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        self.dtype = dtype
        w, p = config.width, config.patch_size
        self.conv1 = nn.Conv2d(3, w, p, p, bias=False)
        with torch.no_grad():
            self.conv1.weight.normal_(0.0, (3 * p * p) ** -0.5, generator=generator)
        self.class_embedding = _normal((w,), 0.02, generator)
        self.positional_embedding = _normal((config.grid ** 2 + 1, w), 0.01, generator)
        self.ln_pre = nn.LayerNorm(w, eps=LN_EPS)
        self.transformer = nn.ModuleDict({"resblocks": nn.ModuleList(
            ResidualAttentionBlock(w, config.heads, generator, config.layers)
            for _ in range(config.layers))})
        self.ln_post = nn.LayerNorm(w, eps=LN_EPS)
        self.proj = _normal((w, config.output_dim), w ** -0.5, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = F.conv2d(images.to(dt).permute(0, 3, 1, 2), self.conv1.weight.to(dt),
                     stride=self.conv1.stride)
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # (B, grid², W), row-major over the grid
        cls = self.class_embedding.to(dt).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = _layer_norm(x, self.ln_pre)
        for block in self.transformer.resblocks:
            x = block(x, dt)
        return _layer_norm(x[:, 0], self.ln_post) @ self.proj


def _is_torchscript(path: Path) -> bool:
    """A TorchScript archive (OpenAI's published ``ViT-B-16.pt``) is a zip
    holding ``constants.pkl`` beside its ``code/``."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as archive:
        return any(name.endswith("/constants.pkl") for name in archive.namelist())


def _visual_state_dict(path: str | Path) -> Dict[str, torch.Tensor]:
    """The visual tower's state dict of a CLIP checkpoint, with the key
    names this module owns. Accepts the forms the JAX package's
    ``load_torch_clip_weights`` does: an OpenAI CLIP state dict (keys
    ``visual.*``; the text tower's keys are dropped) or a visual-only dump;
    an open_clip checkpoint (a ``{"state_dict": ...}`` wrapper, DDP
    ``module.`` prefixes); a TorchScript archive."""
    path = Path(path)
    if _is_torchscript(path):
        sd = torch.jit.load(str(path), map_location="cpu").state_dict()
    else:
        sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]  # open_clip wrapper
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    if any(k.startswith("visual.") for k in sd):
        sd = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
    return sd


def load_torch_clip_weights(path: str | Path, model: CLIPVisionTransformer
                            ) -> CLIPVisionTransformer:
    """Load a CLIP checkpoint's visual tower into ``model`` strictly (the
    values are copied into its float32 parameters, so half-precision
    checkpoints load too). A missing, unexpected or mis-shaped key raises."""
    model.load_state_dict(_visual_state_dict(path), strict=True)
    return model


class ClipFeatureExtractor:
    """The frozen extractor: images (B, H, W, 3), uint8 or ImageNet-
    normalized float, numpy or tensor -> float32 embeddings (B, output_dim)
    on ``device`` (CUDA unless named).

    uint8 pixels are ImageNet-normalized on the device (``normalize_image``:
    the reference applies ImageNet statistics to the CLIP view, not CLIP's
    own), and a side other than the tower's ``image_size`` is resized
    bilinearly (``resize_bilinear``), as in JAX. The tower runs in eval mode
    under ``torch.inference_mode`` with ``requires_grad`` off: no parameter of
    it reaches an optimizer. Random weights come from a CPU generator seeded
    with ``seed``; ``weights_path`` then loads a torch checkpoint strictly
    (``load_torch_clip_weights``), and a file that fails to load raises. ``zeros=True`` returns float32 zeros and builds no tower
    (the reference's fallback, made explicit)."""

    def __init__(self, model_name: str = "ViT-B/16", weights_path: Optional[str | Path] = None,
                 dtype: torch.dtype = torch.bfloat16, zeros: bool = False, device=None,
                 seed: int = 0):
        self.config = CLIP_CONFIGS[model_name]
        self.output_dim = self.config.output_dim
        self.zeros = zeros
        self.device = default_device(device)
        self.model: Optional[CLIPVisionTransformer] = None
        if not zeros:
            model = CLIPVisionTransformer(self.config, dtype=dtype,
                                          generator=torch.Generator().manual_seed(seed))
            if weights_path is not None:
                load_torch_clip_weights(weights_path, model)
            self.model = model.requires_grad_(False).eval().to(self.device)

    @torch.inference_mode()
    def __call__(self, images) -> torch.Tensor:
        images = torch.as_tensor(images)
        if self.zeros:
            return torch.zeros((images.shape[0], self.output_dim), dtype=torch.float32,
                               device=self.device)
        images = normalize_image(images.to(self.device, non_blocking=True))
        side = self.config.image_size
        if tuple(images.shape[1:3]) != (side, side):
            images = resize_bilinear(images, (side, side))
        return self.model(images)
