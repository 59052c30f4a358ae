"""CNN featurizers and the two-CNN patch encoder (counterpart of
wsi_hgnn_tpu/models/featurizers/__init__.py): KimiaNet features and
HoVer-Net nucleus typing over one patch stream, as the reference graph
constructor runs them."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ...utils import resolve_device, set_cuda_numerics, to_torch
from .densenet import DenseNet121, KimiaNet, fuse_kimianet, kimianet_fused_apply
from .hovernet import HoVerNet, hovernet_typing_apply, node_types_on_device

__all__ = ["DenseNet121", "KimiaNet", "HoVerNet", "fuse_kimianet",
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
    from ... import convert

    return convert.to_flax_variables(convert.init_flax_like_(module, seed))


def make_hover_typing_device(hovernet_config: Dict, nr_types: int,
                             device: torch.device, variables: Optional[Dict],
                             seed: int):
    """imgs [B, 256, 256, 3] f32 on the device -> node types [B] int32.
    bf16 weights and inputs on the card (the TPU branch's choice), f32 on
    the CPU."""
    from ... import convert

    if hovernet_config.get("hovernet_model_path"):
        raise NotImplementedError("loading reference HoVer-Net checkpoints "
                                  "is not ported yet; pass variables")
    model = HoVerNet(nr_types=nr_types,
                     mode=hovernet_config.get("mode", "fast"))
    convert.load_flax_variables(
        model, _seeded(model, seed) if variables is None else variables)
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
    Weights come as flax-layout numpy variables; without them the CNNs are
    initialised from `seed` with flax's init distributions. The encoder
    carries its device functions as `encode.stages` ('kimianet', and
    'hovernet' with typing), for per-stage timing."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_cuda_numerics()
    if name != "kimia":
        raise NotImplementedError(f"encoder {name!r} is not ported yet")
    if kimianet_config.get("kimianet_model_path"):
        raise NotImplementedError("loading reference KimiaNet checkpoints "
                                  "is not ported yet; pass kimia_variables")
    nr_types = int(config.get("n_node_type", 6))
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    fp = fuse_kimianet(_seeded(KimiaNet(), seed + 1)
                       if kimia_variables is None else kimia_variables,
                       dtype=dtype, device=dev)

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
