"""CNN featurizers and the two-CNN patch encoder (counterpart of
wsi_hgnn_tpu/models/featurizers/__init__.py): KimiaNet features and
HoVer-Net nucleus typing over one patch stream, as the reference graph
constructor runs them.

Weights, per CNN: flax-layout variables when the caller passes them;
else the reference's torch checkpoint named by `kimianet_model_path` /
`hovernet_model_path` when that file exists (`convert.py` maps its keys,
strict=False over the seeded init); else the seeded init with flax's
distributions, as the JAX package falls back to its random init. One
line per CNN says which weights ran.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ...utils import resolve_device, set_cuda_numerics, to_torch
from . import convert
from .densenet import DenseNet121, KimiaNet, fuse_kimianet, kimianet_fused_apply
from .hovernet import HoVerNet, hovernet_typing_apply, node_types_on_device

__all__ = ["DenseNet121", "KimiaNet", "HoVerNet", "convert", "fuse_kimianet",
           "kimianet_fused_apply", "hovernet_typing_apply",
           "node_types_on_device", "make_cnn_encoder"]


def _norm_pixels(imgs: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> f32 in [0, 1] on the device (the host ships a
    quarter of the bytes); float input passes through."""
    if imgs.dtype == torch.uint8:
        return imgs.to(torch.float32) / 255.0
    return imgs


def _pad_rows(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the batch dim up to a multiple by repeating the last row."""
    r = (-arr.shape[0]) % multiple
    if r:
        arr = np.concatenate([arr, np.repeat(arr[-1:], r, axis=0)])
    return arr


def _make_encode(fn: Callable, device: torch.device,
                 pad_batch_to: Optional[int]):
    """The numpy boundary of every encoder: pad the chunk to the fixed
    batch (one shape for full and trailing chunks), run `fn` on the
    device, slice the pad off, return (features f32, node_types | None).
    uint8 chunks cross to the device unconverted."""
    def encode(patches: np.ndarray):
        arr = np.asarray(patches)
        if arr.dtype != np.uint8:
            arr = np.asarray(arr, np.float32)
        b = arr.shape[0]
        if pad_batch_to:
            arr = _pad_rows(arr, pad_batch_to)
        with torch.inference_mode():
            out = fn(_norm_pixels(to_torch(arr, device)))
        feats, types = out if isinstance(out, tuple) else (out, None)
        feats = feats[:b].float().cpu().numpy()
        return feats, (None if types is None else types[:b].cpu().numpy())

    # serve.featurize keeps patch batches uint8 end to end when it sees this
    encode.accepts_uint8 = True
    return encode


def _seeded(module: torch.nn.Module, seed: int) -> Dict:
    from ... import convert as bridge

    return bridge.to_flax_variables(bridge.init_flax_like_(module, seed))


# HoVer-Net branches the typing module does not run: the reference
# checkpoint's np/hv decoders, and fc1 where a DataParallel checkpoint
# carries it under module.fc1
_NOT_TYPING = ("decoder_np", "decoder_hv", "fc1")


def load_cnn_variables(kind: str, module: torch.nn.Module, path,
                       seed: int, nr_types: int = 6) -> Dict:
    """The variables of `module` ('kimia' or 'hover'): its seeded init,
    overlaid with the torch checkpoint at `path` when that file exists
    (the JAX package's rule). Prints which weights ran."""
    variables = _seeded(module, seed)
    if path and os.path.exists(str(path)):
        if kind == "kimia":
            converted = convert.load_kimianet(path)
        else:
            # the typing module has no fc1 to take the reference net's
            # (the JAX package drops it before converting, too)
            sd = {k: v for k, v in convert.load_torch_state_dict(path).items()
                  if not k.startswith("fc1.")}
            converted = convert.hovernet_torch_to_flax(sd, nr_types)
            converted = {col: {k: v for k, v in tree.items()
                               if k not in _NOT_TYPING}
                         for col, tree in converted.items()}
        variables = convert.merge_into(variables, converted)
        print(f"{kind} weights: {path}", flush=True)
    else:
        why = f"{path} not found" if path else "no weights path set"
        print(f"{kind} weights: seeded init (seed {seed}), {why}", flush=True)
    return variables


def make_hover_typing_device(hovernet_config: Dict, nr_types: int,
                             device: torch.device, variables: Optional[Dict],
                             seed: int):
    """imgs [B, 256, 256, 3] f32 on the device -> node types [B] int32.
    bf16 weights and inputs on the card (the TPU branch's choice), f32 on
    the CPU."""
    from ... import convert as bridge

    model = HoVerNet(nr_types=nr_types,
                     mode=hovernet_config.get("mode", "fast"))
    if variables is None:
        variables = load_cnn_variables(
            "hover", model, hovernet_config.get("hovernet_model_path"), seed,
            nr_types)
    bridge.load_flax_variables(model, variables)
    dtype = torch.float32
    model = model.eval().to(device)
    if device.type == "cuda":
        dtype = torch.bfloat16
        model = model.to(dtype=dtype, memory_format=torch.channels_last)

    def typing_dev(imgs):
        return hovernet_typing_apply(model, imgs.to(dtype), nr_types)

    return typing_dev


def make_cnn_encoder(name: str, config: Dict, hovernet_config: Dict,
                     kimianet_config: Dict, with_typing: bool = False,
                     pad_batch_to: Optional[int] = None, device=None,
                     kimia_variables: Optional[Dict] = None,
                     hover_variables: Optional[Dict] = None, seed: int = 0):
    """`(patches [B, 256, 256, 3] uint8 or f32) -> (features [B, 1024] f32,
    node_types [B] int32 | None)`.

    'kimia' runs the fused KimiaNet (the hand-written dense-layer and
    transition kernels; bf16 storage on the card, f32 on the CPU).
    with_typing also runs HoVer-Net typing on the same uploaded chunk.
    Weights come as flax-layout numpy variables, else from the configs'
    weights paths where the files exist, else from `seed` with flax's
    init distributions (module docstring). The encoder
    carries its device functions as `encode.stages` ('kimianet', and
    'hovernet' with typing), for per-stage timing."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_cuda_numerics()
    if name != "kimia":
        raise NotImplementedError(f"encoder {name!r} is not ported yet")
    nr_types = int(config.get("n_node_type", 6))
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if kimia_variables is None:
        kimia_variables = load_cnn_variables(
            "kimia", KimiaNet(), kimianet_config.get("kimianet_model_path"),
            seed + 1)
    fp = fuse_kimianet(kimia_variables, dtype=dtype, device=dev)

    def feat_part(imgs):
        return kimianet_fused_apply(fp, imgs.to(dtype))[0]

    fn = feat_part
    stages = {"kimianet": feat_part}
    if with_typing:
        typing_dev = make_hover_typing_device(
            dict(hovernet_config), nr_types, dev, hover_variables, seed)
        stages["hovernet"] = typing_dev

        def fn(imgs):
            return feat_part(imgs), typing_dev(imgs)

    encode = _make_encode(fn, dev, pad_batch_to)
    encode.stages = stages  # normalised device pixels in, device tensors out
    return encode
