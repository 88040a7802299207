"""Image towers for the CLIP loss and CLIPScore (the JAX package's
`metrics/clip_encoder.py`): ViT (OpenAI CLIP, SigLIP, EVA-CLIP trunks) and
CLIP's ModifiedResNet (RN50), as frozen torch modules.

There is no download. A tower is either
1. imported from a local torch state dict (`weights_path`, or the
   environment variable SSR_TPU_CLIP_WEIGHTS): OpenAI CLIP ViT
   (`visual.conv1.weight`, `visual.transformer.resblocks.*`), open_clip
   SigLIP (a timm trunk under `visual.trunk.*`) or a bare timm ViT, timm Eva
   (post-norm EVA-CLIP trunk), or OpenAI CLIP RN (BatchNorms folded into
   per-conv scale and shift). A file the user supplies never degrades
   quietly to a random tower: a missing file, one that matches no naming
   family, or one that matches a family but lacks its keys raises
   `TowerImportError`.
2. or else a seeded random tower of the spec's geometry, drawn from
   np.random.RandomState(0) in the JAX package's order, so both packages
   build the same weights with no conversion. Its numbers are
   self-consistent only; metrics computed with it are tagged
   `(untrained-tower)` (metrics/__init__.py).

Params are first the JAX package's nested numpy dict (`tower_params`);
`tower_from_params` loads such a dict into the port's module through
`utils/torch_io.tower_from_jax`. The forward is structure-driven as the
JAX one: `cls` selects the class token (and `ln_pre` OpenAI's pre-norm),
`attn_pool` the SigLIP MAP head, else mean-pool + ln + head. Attention is
matmul + softmax in float32, scores scaled by 1/sqrt(d) before the softmax;
GELU is exact (erf), or quick-GELU where the spec says. Towers compute in
float32 whatever the trainer's compute dtype, as the JAX towers close over
float32 params. Each tower is built once per (name, weights path, device)
and process.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class ViTSpec:
    image_size: int
    patch_size: int
    width: int
    layers: int
    heads: int
    embed_dim: int
    mlp_ratio: float = 4.0
    act: str = "gelu"  # gelu | quick_gelu
    pool: str = "mean"  # mean | cls | map (MAP = timm AttentionPoolLatent)
    ln_eps: float = 1e-5  # OpenAI CLIP: 1e-5; timm/SigLIP ViTs: 1e-6
    # timm Eva "post-norm" residual blocks (x + norm(attn(x)), x + norm(mlp(x)))
    post_norm: bool = False


@dataclasses.dataclass(frozen=True)
class ResNetSpec:
    """CLIP ModifiedResNet geometry (anti-aliased stem/downsampling + MHA pool)."""

    image_size: int
    width: int  # stem width (RN50: 64)
    layers: tuple  # bottleneck counts per stage (RN50: (3, 4, 6, 3))
    embed_dim: int
    heads: int  # attention-pool heads (RN50: 32)


MODEL_SPECS: Dict[str, object] = {
    # loss towers (ssr/losses/basic_loss.py:26-34). EVA02-E-14-plus's image
    # tower is timm eva02_enormous_patch14_clip_224: 64 post-norm blocks,
    # width 1792, mlp 15360, q/v-only qkv biases, cls pooling, head 1792->1024
    "EVA02-E-14-plus": ViTSpec(224, 14, 1792, 64, 16, 1024,
                               mlp_ratio=15360 / 1792, pool="cls",
                               ln_eps=1e-6, post_norm=True),
    "ViT-B-16-SigLIP-256": ViTSpec(256, 16, 768, 12, 12, 768, pool="map",
                                   ln_eps=1e-6),
    "RN50": ResNetSpec(224, 64, (3, 4, 6, 3), 1024, 32),
    # metric towers (ssr/metrics/clipscore.py:12-22)
    "clip-ViT-B/16": ViTSpec(224, 16, 768, 12, 12, 512, act="quick_gelu", pool="cls"),
    "clipa-ViT-bigG-14": ViTSpec(336, 14, 1664, 48, 16, 1280),
    # SoViT-400M/14: mlp dim 4304 (not 4x), 27 layers, MAP head
    "siglip-ViT-SO400M-14": ViTSpec(384, 14, 1152, 27, 16, 1152,
                                    mlp_ratio=4304 / 1152, pool="map",
                                    ln_eps=1e-6),
    # tiny towers for tests (one per pooling/act variant)
    "test-tiny": ViTSpec(32, 8, 32, 2, 2, 16),
    "test-tiny-openai": ViTSpec(32, 8, 32, 2, 2, 16, act="quick_gelu", pool="cls"),
    "test-tiny-siglip": ViTSpec(32, 8, 32, 2, 2, 32, pool="map", ln_eps=1e-6),
    "test-tiny-rn": ResNetSpec(32, 4, (1, 1, 1, 1), 16, 4),
    "test-tiny-eva": ViTSpec(32, 8, 32, 2, 2, 16, pool="cls", ln_eps=1e-6,
                             post_norm=True),
}


def _mlp_dim(spec: ViTSpec) -> int:
    return int(round(spec.width * spec.mlp_ratio))


# -- seeded random towers (the JAX package's draws, in its order) -----------------


def _init_vit_params(spec: ViTSpec, seed: int = 0) -> Dict:
    rng = np.random.RandomState(seed)
    n_patches = (spec.image_size // spec.patch_size) ** 2
    w = spec.width

    def dense(i, o):
        return {
            "kernel": (rng.randn(i, o) * (1.0 / np.sqrt(i))).astype(np.float32),
            "bias": np.zeros((o,), np.float32),
        }

    def ln():
        return {"scale": np.ones((w,), np.float32), "bias": np.zeros((w,), np.float32)}

    mlp_dim = _mlp_dim(spec)
    blocks = []
    for _ in range(spec.layers):
        blocks.append(
            {
                "ln1": ln(),
                "qkv": dense(w, 3 * w),
                "proj": dense(w, w),
                "ln2": ln(),
                "fc1": dense(w, mlp_dim),
                "fc2": dense(mlp_dim, w),
            }
        )
    n_tokens = n_patches + (1 if spec.pool == "cls" else 0)
    params = {
        "patch": {
            "kernel": (
                rng.randn(spec.patch_size, spec.patch_size, 3, w)
                * (1.0 / np.sqrt(spec.patch_size**2 * 3))
            ).astype(np.float32),
            "bias": np.zeros((w,), np.float32),
        },
        "pos": (rng.randn(n_tokens, w) * 0.02).astype(np.float32),
        "blocks": blocks,
        "ln_final": ln(),
    }
    if spec.pool == "cls":
        params["cls"] = (rng.randn(w) * 0.02).astype(np.float32)
        if not spec.post_norm:  # ln_pre is OpenAI-CLIP-specific; Eva has none
            params["ln_pre"] = ln()
    if spec.pool == "map":
        params["attn_pool"] = {
            "latent": (rng.randn(w) * 0.02).astype(np.float32),
            "q": dense(w, w),
            "kv": dense(w, 2 * w),
            "proj": dense(w, w),
            "norm": ln(),
            "fc1": dense(w, mlp_dim),
            "fc2": dense(mlp_dim, w),
        }
    else:
        params["head"] = dense(w, spec.embed_dim)
    return params


def _rn_stage_planes(width: int):
    return [width, width * 2, width * 4, width * 8]


def _init_rn_params(spec: ResNetSpec, seed: int = 0) -> Dict:
    rng = np.random.RandomState(seed)

    def conv(k, i, o):
        fan_in = k * k * i
        return {
            "kernel": (rng.randn(k, k, i, o) * np.sqrt(2.0 / fan_in)).astype(np.float32),
            "scale": np.ones((o,), np.float32),
            "shift": np.zeros((o,), np.float32),
        }

    def dense(i, o):
        return {
            "kernel": (rng.randn(i, o) * (1.0 / np.sqrt(i))).astype(np.float32),
            "bias": np.zeros((o,), np.float32),
        }

    w = spec.width
    stem = [conv(3, 3, w // 2), conv(3, w // 2, w // 2), conv(3, w // 2, w)]
    layers = []
    in_ch = w
    for si, (planes, n_blocks) in enumerate(zip(_rn_stage_planes(w), spec.layers)):
        stage = []
        for bi in range(n_blocks):
            stride = (2 if si > 0 else 1) if bi == 0 else 1
            blk = {
                "conv1": conv(1, in_ch, planes),
                "conv2": conv(3, planes, planes),
                "conv3": conv(1, planes, planes * 4),
                "stride": stride,
            }
            if stride > 1 or in_ch != planes * 4:
                blk["down"] = conv(1, in_ch, planes * 4)
            stage.append(blk)
            in_ch = planes * 4
        layers.append(stage)
    n_spacial = (spec.image_size // 32) ** 2
    pool = {
        "pos": (rng.randn(n_spacial + 1, in_ch) / np.sqrt(in_ch)).astype(np.float32),
        "q": dense(in_ch, in_ch),
        "k": dense(in_ch, in_ch),
        "v": dense(in_ch, in_ch),
        "c": dense(in_ch, spec.embed_dim),
    }
    return {"stem": stem, "layers": layers, "attnpool": pool}


# -- torch state-dict importers ----------------------------------------------------


class TowerImportError(ValueError):
    """A weights file is missing, matches no naming family, or matches one
    but lacks its keys: raised instead of a crash mid-import or a quiet
    fall back to the random tower."""


def _np(t) -> np.ndarray:
    return t.float().numpy()


def _strict(state, key):
    if key not in state:
        raise TowerImportError(
            f"tower state dict missing {key!r}: naming family detected but the "
            "layout is unsupported (wrong model spec, or a tower variant this "
            "importer does not map)")
    return _np(state[key])


def _load_state(path: str):
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return state


def _import_clip_rn(state, spec: ResNetSpec) -> Optional[Dict]:
    """OpenAI CLIP RN* visual tower; folds each BatchNorm into its conv."""
    if "visual.conv1.weight" not in state or "visual.attnpool.q_proj.weight" not in state:
        return None
    req = lambda k: _strict(state, k)

    def conv_bn(conv_key, bn_key):
        if f"{conv_key}.weight" not in state:
            return None
        w = _np(state[f"{conv_key}.weight"])
        gamma, beta = req(f"{bn_key}.weight"), req(f"{bn_key}.bias")
        mean, var = req(f"{bn_key}.running_mean"), req(f"{bn_key}.running_var")
        scale = gamma / np.sqrt(var + 1e-5)
        return {
            "kernel": np.transpose(w, (2, 3, 1, 0)),
            "scale": scale.astype(np.float32),
            "shift": (beta - mean * scale).astype(np.float32),
        }

    stem = [conv_bn(f"visual.conv{i}", f"visual.bn{i}") for i in (1, 2, 3)]
    if any(s is None for s in stem):
        return None
    layers = []
    for si in range(4):
        stage = []
        bi = 0
        while f"visual.layer{si + 1}.{bi}.conv1.weight" in state:
            base = f"visual.layer{si + 1}.{bi}"
            blk = {
                "conv1": conv_bn(f"{base}.conv1", f"{base}.bn1"),
                "conv2": conv_bn(f"{base}.conv2", f"{base}.bn2"),
                "conv3": conv_bn(f"{base}.conv3", f"{base}.bn3"),
                "stride": (2 if si > 0 else 1) if bi == 0 else 1,
            }
            if f"{base}.downsample.0.weight" in state:
                blk["down"] = conv_bn(f"{base}.downsample.0", f"{base}.downsample.1")
            stage.append(blk)
            bi += 1
        if bi != spec.layers[si]:
            raise TowerImportError(
                f"CLIP RN stage {si + 1} has {bi} blocks, spec expects "
                f"{spec.layers[si]} — wrong model spec for this checkpoint")
        layers.append(stage)

    def lin(k):
        return {"kernel": req(f"visual.attnpool.{k}.weight").T,
                "bias": req(f"visual.attnpool.{k}.bias")}

    pool = {"pos": req("visual.attnpool.positional_embedding"),
            "q": lin("q_proj"), "k": lin("k_proj"), "v": lin("v_proj"), "c": lin("c_proj")}
    return {"stem": stem, "layers": layers, "attnpool": pool}


def _identity_head(w: int, embed_dim: int) -> Dict:
    return {"kernel": np.eye(w, embed_dim, dtype=np.float32),
            "bias": np.zeros((embed_dim,), np.float32)}


def _import_openai_clip(state, spec: ViTSpec) -> Optional[Dict]:
    """OpenAI/open_clip CLIP ViT visual tower: cls token, ln_pre, quick_gelu,
    ln_post on the cls token, then @ proj."""
    req = lambda k: _strict(state, k)
    if "visual.conv1.weight" not in state:
        return None
    conv = _np(state["visual.conv1.weight"])  # [W, 3, P, P], bias-free in CLIP
    w = conv.shape[0]
    params: Dict = {
        "patch": {"kernel": np.transpose(conv, (2, 3, 1, 0)),
                  "bias": np.zeros((w,), np.float32)},
        "cls": req("visual.class_embedding"),
        "pos": req("visual.positional_embedding"),  # [(n+1), W], row 0 = cls
        "blocks": [],
        "ln_final": {"scale": req("visual.ln_post.weight"),
                     "bias": req("visual.ln_post.bias")},
    }
    if "visual.ln_pre.weight" in state:
        params["ln_pre"] = {"scale": req("visual.ln_pre.weight"),
                            "bias": req("visual.ln_pre.bias")}
    for i in range(spec.layers):
        base = f"visual.transformer.resblocks.{i}"
        if f"{base}.ln_1.weight" not in state:
            raise TowerImportError(
                f"CLIP ViT is missing block {i} of the {spec.layers} the model "
                "spec expects — wrong model spec for this checkpoint")
        params["blocks"].append({
            "ln1": {"scale": req(f"{base}.ln_1.weight"), "bias": req(f"{base}.ln_1.bias")},
            "qkv": {"kernel": req(f"{base}.attn.in_proj_weight").T,
                    "bias": req(f"{base}.attn.in_proj_bias")},
            "proj": {"kernel": req(f"{base}.attn.out_proj.weight").T,
                     "bias": req(f"{base}.attn.out_proj.bias")},
            "ln2": {"scale": req(f"{base}.ln_2.weight"), "bias": req(f"{base}.ln_2.bias")},
            "fc1": {"kernel": req(f"{base}.mlp.c_fc.weight").T,
                    "bias": req(f"{base}.mlp.c_fc.bias")},
            "fc2": {"kernel": req(f"{base}.mlp.c_proj.weight").T,
                    "bias": req(f"{base}.mlp.c_proj.bias")},
        })
    if "visual.proj" in state:
        proj = _np(state["visual.proj"])  # [W, E]
        params["head"] = {"kernel": proj, "bias": np.zeros((proj.shape[1],), np.float32)}
    else:
        params["head"] = _identity_head(w, spec.embed_dim)
    return params


def _vit_block(req, base: str, qkv_bias: np.ndarray) -> Dict:
    """One timm block (ViT or Eva naming) with the given fused qkv bias."""
    return {
        "ln1": {"scale": req(f"{base}.norm1.weight"), "bias": req(f"{base}.norm1.bias")},
        "qkv": {"kernel": req(f"{base}.attn.qkv.weight").T, "bias": qkv_bias},
        "proj": {"kernel": req(f"{base}.attn.proj.weight").T,
                 "bias": req(f"{base}.attn.proj.bias")},
        "ln2": {"scale": req(f"{base}.norm2.weight"), "bias": req(f"{base}.norm2.bias")},
        "fc1": {"kernel": req(f"{base}.mlp.fc1.weight").T, "bias": req(f"{base}.mlp.fc1.bias")},
        "fc2": {"kernel": req(f"{base}.mlp.fc2.weight").T, "bias": req(f"{base}.mlp.fc2.bias")},
    }


def _timm_trunk(state, spec: ViTSpec, prefix: str, family: str):
    """(req, width, params) of a timm trunk's patch embedding and final norm,
    or None when `prefix` has no patch embedding."""
    req = lambda k: _strict(state, prefix + k)
    if prefix + "patch_embed.proj.weight" not in state:
        return None
    conv = _np(state[prefix + "patch_embed.proj.weight"])  # [W, 3, P, P]
    w = conv.shape[0]
    bias_key = prefix + "patch_embed.proj.bias"
    params: Dict = {
        "patch": {"kernel": np.transpose(conv, (2, 3, 1, 0)),
                  "bias": _np(state[bias_key]) if bias_key in state else np.zeros((w,), np.float32)},
        "pos": req("pos_embed").reshape(-1, w),
        "blocks": [],
        "ln_final": {"scale": req("norm.weight"), "bias": req("norm.bias")},
    }
    for i in range(spec.layers):
        if prefix + f"blocks.{i}.norm1.weight" not in state:
            raise TowerImportError(
                f"timm {family} is missing block {i} of the {spec.layers} the model "
                "spec expects — wrong model spec for this checkpoint")
    return req, w, params


def _import_timm_vit(state, spec: ViTSpec, prefix: str) -> Optional[Dict]:
    """timm VisionTransformer (open_clip SigLIP towers live under
    `visual.trunk.`): fused qkv, exact gelu, final norm, MAP attention pool."""
    trunk = _timm_trunk(state, spec, prefix, "ViT")
    if trunk is None:
        return None
    req, w, params = trunk
    for i in range(spec.layers):
        params["blocks"].append(_vit_block(req, f"blocks.{i}", req(f"blocks.{i}.attn.qkv.bias")))
    if prefix + "attn_pool.latent" in state:
        lin = lambda k: {"kernel": req(f"attn_pool.{k}.weight").T, "bias": req(f"attn_pool.{k}.bias")}
        params["attn_pool"] = {
            "latent": req("attn_pool.latent").reshape(-1),
            "q": lin("q"), "kv": lin("kv"), "proj": lin("proj"),
            "norm": {"scale": req("attn_pool.norm.weight"), "bias": req("attn_pool.norm.bias")},
            "fc1": lin("mlp.fc1"), "fc2": lin("mlp.fc2"),
        }
    else:
        params["head"] = _identity_head(w, spec.embed_dim)
    return params


def _import_timm_eva(state, spec: ViTSpec, prefix: str) -> Optional[Dict]:
    """timm Eva trunk (open_clip EVA-CLIP towers live under `visual.trunk.`):
    fused qkv whose bias is (q_bias, 0, v_bias), cls token, abs pos-emb,
    post-norm blocks, final norm, classifier head as the CLIP projection.
    The SwiGLU/RoPE eva02 B/L trunks are refused: RoPE has no parameters in
    the state dict, so importing without it would give wrong embeddings."""
    if prefix + "patch_embed.proj.weight" not in state:
        return None
    if (prefix + "blocks.0.mlp.fc1_g.weight" in state
            or prefix + "blocks.0.attn.q_proj.weight" in state):
        raise TowerImportError(
            "eva02 SwiGLU/RoPE trunk detected (mlp.fc1_g / attn.q_proj naming)"
            " — only the post-norm EVA-CLIP trunk (eva02_*_clip_224, the"
            " EVA02-E-14-plus image tower) is supported; refusing rather than"
            " dropping RoPE and producing wrong embeddings")
    req, w, params = _timm_trunk(state, spec, prefix, "Eva")
    params["cls"] = req("cls_token").reshape(-1)  # pos row 0 is the cls token's
    for i in range(spec.layers):
        q_b, v_b = req(f"blocks.{i}.attn.q_bias"), req(f"blocks.{i}.attn.v_bias")
        # Eva's fused qkv Linear is bias-free; k's bias is a zeros buffer
        params["blocks"].append(
            _vit_block(req, f"blocks.{i}", np.concatenate([q_b, np.zeros_like(q_b), v_b])))
    if prefix + "head.weight" in state:
        head = _np(state[prefix + "head.weight"])  # [E, W]: the CLIP projection
        head_b = prefix + "head.bias"
        params["head"] = {"kernel": head.T,
                          "bias": _np(state[head_b]) if head_b in state
                          else np.zeros((head.shape[0],), np.float32)}
    else:
        params["head"] = _identity_head(w, spec.embed_dim)
    return params


def _is_eva_family(state, prefix: str) -> bool:
    sig = ("blocks.0.attn.q_bias", "blocks.0.attn.q_proj.weight", "blocks.0.mlp.fc1_g.weight")
    return any(prefix + k in state for k in sig)


def load_vit_from_torch(path: str, spec: ViTSpec) -> Optional[Dict]:
    """Import a ViT image-tower state dict; detects the naming convention.
    None when it matches no family."""
    state = _load_state(path)
    if any(k.startswith("visual.conv1") for k in state):
        return _import_openai_clip(state, spec)
    for prefix in ("visual.trunk.", ""):
        if any(k.startswith(prefix + "patch_embed.proj") for k in state):
            if _is_eva_family(state, prefix):
                return _import_timm_eva(state, spec, prefix)
            return _import_timm_vit(state, spec, prefix)
    return None


# -- the port's modules --------------------------------------------------------------


def _linear(p: Dict) -> nn.Linear:
    i, o = p["kernel"].shape
    return nn.Linear(i, o, device="meta")


def _layer_norm(p: Dict, eps: float) -> nn.LayerNorm:
    return nn.LayerNorm(p["scale"].shape[0], eps=eps, device="meta")


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over [..., n, d], in float32."""
    scores = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(scores, dim=-1), v)


class _Block(nn.Module):
    def __init__(self, p: Dict, eps: float):
        super().__init__()
        self.ln1, self.ln2 = _layer_norm(p["ln1"], eps), _layer_norm(p["ln2"], eps)
        self.qkv, self.proj = _linear(p["qkv"]), _linear(p["proj"])
        self.fc1, self.fc2 = _linear(p["fc1"]), _linear(p["fc2"])


class _AttentionPool(nn.Module):
    """timm AttentionPoolLatent (latent_len=1, no pos): the SigLIP MAP head."""

    def __init__(self, p: Dict, heads: int, eps: float):
        super().__init__()
        self.heads = heads
        self.latent = nn.Parameter(torch.empty(p["latent"].shape, device="meta"))
        self.q, self.kv, self.proj = _linear(p["q"]), _linear(p["kv"]), _linear(p["proj"])
        self.norm = _layer_norm(p["norm"], eps)
        self.fc1, self.fc2 = _linear(p["fc1"]), _linear(p["fc2"])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, n, w = h.shape
        d = w // self.heads
        q = self.q(self.latent).reshape(self.heads, 1, d)
        kv = self.kv(h).reshape(b, n, 2, self.heads, d).permute(2, 0, 3, 1, 4)
        x = _attention(q, kv[0], kv[1]).reshape(b, w)
        x = self.proj(x)
        return x + self.fc2(F.gelu(self.fc1(self.norm(x))))


class ViTEncoder(nn.Module):
    """NHWC image (normalised) -> [B, embed_dim]; `_vit_encode` of the JAX
    package. Which parts exist follows the params dict it is built from."""

    def __init__(self, spec: ViTSpec, params: Dict):
        super().__init__()
        self.spec = spec
        p, _, _, w = params["patch"]["kernel"].shape
        self.patch = nn.Conv2d(3, w, p, stride=spec.patch_size, device="meta")
        self.pos = nn.Parameter(torch.empty(params["pos"].shape, device="meta"))
        self.cls = (nn.Parameter(torch.empty(params["cls"].shape, device="meta"))
                    if "cls" in params else None)
        eps = spec.ln_eps
        self.ln_pre = _layer_norm(params["ln_pre"], eps) if "ln_pre" in params else None
        self.blocks = nn.ModuleList(_Block(b, eps) for b in params["blocks"])
        self.ln_final = _layer_norm(params["ln_final"], eps)
        self.attn_pool = (_AttentionPool(params["attn_pool"], spec.heads, eps)
                          if "attn_pool" in params else None)
        self.head = _linear(params["head"]) if "head" in params else None

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        if self.spec.act == "quick_gelu":  # OpenAI CLIP's QuickGELU
            return x * torch.sigmoid(1.702 * x)
        return F.gelu(x)

    def _self_attn(self, y: torch.Tensor, blk: _Block) -> torch.Tensor:
        b, n, w = y.shape
        heads = self.spec.heads
        qkv = blk.qkv(y).reshape(b, n, 3, heads, w // heads).permute(2, 0, 3, 1, 4)
        y = _attention(qkv[0], qkv[1], qkv[2]).transpose(1, 2).reshape(b, n, w)
        return blk.proj(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.patch(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)  # [B, n, W]
        if self.cls is not None:
            h = torch.cat([self.cls.expand(h.shape[0], 1, -1), h], dim=1)
        h = h + self.pos
        if self.ln_pre is not None:
            h = self.ln_pre(h)
        for blk in self.blocks:
            if self.spec.post_norm:  # timm EvaBlockPostNorm
                h = h + blk.ln1(self._self_attn(h, blk))
                h = h + blk.ln2(blk.fc2(self._act(blk.fc1(h))))
            else:
                h = h + self._self_attn(blk.ln1(h), blk)
                h = h + blk.fc2(self._act(blk.fc1(blk.ln2(h))))
        if self.attn_pool is not None:
            return self.attn_pool(self.ln_final(h))
        if self.cls is not None:
            return self.head(self.ln_final(h[:, 0]))
        return self.head(self.ln_final(h.mean(dim=1)))


class _ConvBN(nn.Module):
    """A bias-free conv with its BatchNorm folded into (scale, shift)."""

    def __init__(self, p: Dict, stride: int = 1, pad: int = 0):
        super().__init__()
        k, _, i, o = p["kernel"].shape
        self.stride, self.pad = stride, pad
        self.weight = nn.Parameter(torch.empty(o, i, k, k, device="meta"))
        self.scale = nn.Parameter(torch.empty(o, device="meta"))
        self.shift = nn.Parameter(torch.empty(o, device="meta"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.conv2d(x, self.weight, stride=self.stride, padding=self.pad)
        return h * self.scale[:, None, None] + self.shift[:, None, None]


class _Bottleneck(nn.Module):
    def __init__(self, p: Dict):
        super().__init__()
        self.stride = int(p["stride"])
        self.conv1, self.conv2 = _ConvBN(p["conv1"]), _ConvBN(p["conv2"], pad=1)
        self.conv3 = _ConvBN(p["conv3"])
        self.down = _ConvBN(p["down"]) if "down" in p else None

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv2(F.relu(self.conv1(h))))
        if self.stride > 1:  # anti-aliased: avgpool, then the conv
            out = F.avg_pool2d(out, self.stride)
        out = self.conv3(out)
        idn = h
        if self.down is not None:
            if self.stride > 1:
                idn = F.avg_pool2d(idn, self.stride)
            idn = self.down(idn)
        return F.relu(out + idn)


class ResNetEncoder(nn.Module):
    """CLIP ModifiedResNet, NHWC in -> [B, embed_dim]; `_rn_encode` of the
    JAX package: 3-conv stem with avgpool, bottlenecks, AttentionPool2d with
    the mean token as the query over (mean + spatial tokens) + pos."""

    def __init__(self, spec: ResNetSpec, params: Dict):
        super().__init__()
        self.heads = spec.heads
        s = params["stem"]
        self.stem = nn.ModuleList([_ConvBN(s[0], stride=2, pad=1), _ConvBN(s[1], pad=1),
                                   _ConvBN(s[2], pad=1)])
        self.layers = nn.ModuleList(nn.ModuleList(_Bottleneck(b) for b in stage)
                                    for stage in params["layers"])
        p = params["attnpool"]
        self.attnpool = nn.Module()
        self.attnpool.pos = nn.Parameter(torch.empty(p["pos"].shape, device="meta"))
        for name in ("q", "k", "v", "c"):
            setattr(self.attnpool, name, _linear(p[name]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for conv in self.stem:
            h = F.relu(conv(h))
        h = F.avg_pool2d(h, 2)
        for stage in self.layers:
            for blk in stage:
                h = blk(h)
        p = self.attnpool
        b, c = h.shape[:2]
        tokens = h.flatten(2).transpose(1, 2)  # [B, HW, C], row-major as NHWC
        xq = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1) + p.pos
        d = c // self.heads
        q = p.q(xq[:, :1]).reshape(b, 1, self.heads, d).transpose(1, 2)
        k = p.k(xq).reshape(b, -1, self.heads, d).transpose(1, 2)
        v = p.v(xq).reshape(b, -1, self.heads, d).transpose(1, 2)
        return p.c(_attention(q, k, v).reshape(b, c))


def tower_from_params(spec, params: Dict, device="cuda") -> nn.Module:
    """The port's frozen, eval-mode tower for a JAX-layout numpy param dict
    (the random init's, an importer's, or the JAX package's own), on
    `device`, in float32."""
    from ..utils.torch_io import tower_from_jax

    cls = ResNetEncoder if isinstance(spec, ResNetSpec) else ViTEncoder
    module = cls(spec, params)
    module.load_state_dict(tower_from_jax(params), strict=True, assign=True)
    return module.to(resolve_device(device)).requires_grad_(False).eval()


# -- cached towers ---------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def tower_params(model_name: str, weights_path: Optional[str]) -> Tuple[Dict, bool]:
    """(JAX-layout numpy params, pretrained) for a tower, read or drawn once
    per process. A supplied weights file is imported or refused, never
    replaced by the random tower."""
    spec = MODEL_SPECS[model_name]
    is_rn = isinstance(spec, ResNetSpec)
    if weights_path:
        weights_path = os.path.expanduser(weights_path)
        if not os.path.exists(weights_path):
            raise TowerImportError(f"tower weights file {weights_path!r} does not exist")
        params = (_import_clip_rn(_load_state(weights_path), spec) if is_rn
                  else load_vit_from_torch(weights_path, spec))
        if params is None:
            raise TowerImportError(
                f"tower weights file {weights_path!r} matched no known naming"
                " family (OpenAI CLIP visual / open_clip-SigLIP visual.trunk /"
                " bare timm ViT / timm Eva / CLIP RN) — refusing to fall back"
                " to a random tower for user-supplied weights")
        return params, True
    return (_init_rn_params(spec) if is_rn else _init_vit_params(spec)), False


@functools.lru_cache(maxsize=4)
def _cached_tower(model_name: str, weights_path: Optional[str], device: str) -> nn.Module:
    params, _ = tower_params(model_name, weights_path)
    return tower_from_params(MODEL_SPECS[model_name], params, device)


def get_encoder(model_name: str, weights_path: Optional[str] = None,
                device="cuda") -> Tuple[nn.Module, bool]:
    """(frozen tower on `device`, pretrained) for a MODEL_SPECS name; the
    weights path defaults to SSR_TPU_CLIP_WEIGHTS."""
    weights_path = weights_path or os.environ.get("SSR_TPU_CLIP_WEIGHTS")
    _, pretrained = tower_params(model_name, weights_path)
    return _cached_tower(model_name, weights_path, device_key(device)), pretrained


def is_pretrained(model_name: str, weights_path: Optional[str] = None) -> bool:
    """Whether get_encoder's tower carries imported weights (reads or draws
    the params, builds no module)."""
    return tower_params(model_name, weights_path or os.environ.get("SSR_TPU_CLIP_WEIGHTS"))[1]


def device_key(device) -> str:
    """One name per device ('cuda' and 'cuda:0' are one card), for caches."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)
