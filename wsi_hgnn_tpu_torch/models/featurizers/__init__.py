"""CNN featurizers and the patch encoders (counterpart of
wsi_hgnn_tpu/models/featurizers/__init__.py), as the reference graph
constructor runs them over one patch stream: 'kimia' (KimiaNet features),
'efficientnet-b4' (EfficientNet-B4 features) and 'uni2-h' (the UNI2-h
ViT's CLS features, vit.py), each with HoVer-Net nucleus typing inline
when asked, and 'hover' (HoVer-Net's fc1 features and its own types).

Weights, per CNN: flax-layout variables when the caller passes them;
else the reference's torch checkpoint named by `kimianet_model_path` /
`hovernet_model_path` / `efficientnet_model_path` when that file exists
(`convert.py` maps its keys, strict=False over the seeded init); else the
seeded init with flax's distributions, as the JAX package falls back to
its random init. UNI2-h takes a timm state dict (`vit_state_dict`, or
the file at `uni2h_model_path`), else timm's seeded init. One line per
network says which weights ran. HoVer-Net's fc1 kernel (4.3 GB in f32 at
1024 features) is seeded on the encoder's own device when no file holds
it, never on the host.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ...profiling import span
from ...utils import resolve_device, set_cuda_numerics
from . import convert
from .densenet import DenseNet121, KimiaNet, fuse_kimianet, kimianet_fused_apply
from .efficientnet import EfficientNet, efficientnet_apply
from .effnetv2 import EffNetV2
from .hovernet import (HoVerNet, hovernet_full_apply, hovernet_typing_apply,
                       node_types_from_tp, node_types_on_device)
from .vit import ViT, make_vit, vit_apply

__all__ = ["DenseNet121", "KimiaNet", "EfficientNet", "EffNetV2", "HoVerNet",
           "ViT", "make_vit", "vit_apply", "convert", "fuse_kimianet",
           "kimianet_fused_apply",
           "efficientnet_apply", "hovernet_typing_apply",
           "hovernet_full_apply", "node_types_from_tp",
           "node_types_on_device", "make_cnn_encoder", "make_hover_typing",
           "make_hovernet"]


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


def _make_encode(build: Callable, devices, pad_batch_to: Optional[int]):
    """The numpy boundary of every encoder: pad the chunk to the fixed
    batch (one shape for full and trailing chunks), then to a multiple of
    the device count (repeating the last row, as the JAX package's
    `_pad_rows`), run it split over the devices (`build(device)` is one
    device's function of normalised pixels; parallel.mesh.
    make_sharded_batch_apply), slice the pad off, return (features f32,
    node_types | None). uint8 chunks cross to the devices unconverted.
    `encode` is `encode.finish(encode.launch(patches))`; serve.featurize
    launches a chunk before it finishes the one before."""
    from ...parallel.mesh import make_sharded_batch_apply

    devices = tuple(devices)
    run = make_sharded_batch_apply(
        lambda d: (lambda p, f=build(d): f(_norm_pixels(p))), devices)

    def launch(patches: np.ndarray):
        arr = np.asarray(patches)
        if arr.dtype != np.uint8:
            arr = np.asarray(arr, np.float32)
        b = arr.shape[0]
        if pad_batch_to:
            arr = _pad_rows(arr, pad_batch_to)
        arr = _pad_rows(arr, len(devices))
        with torch.inference_mode():
            return b, run.launch(torch.from_numpy(np.ascontiguousarray(arr)))

    def finish(launched):
        b, pending = launched
        out = run.finish(pending)
        feats, types = out if isinstance(out, tuple) else (out, None)
        feats = feats[:b].float().numpy()
        return feats, (None if types is None else types[:b].numpy())

    def encode(patches: np.ndarray):
        return finish(launch(patches))

    encode.launch, encode.finish = launch, finish
    # serve.featurize keeps patch batches uint8 end to end when it sees this
    encode.accepts_uint8 = True
    encode.devices = devices
    return encode


def _seeded(module: torch.nn.Module, seed: int) -> Dict:
    from ... import convert as bridge

    return bridge.to_flax_variables(bridge.init_flax_like_(module, seed))


def load_cnn_variables(kind: str, module: torch.nn.Module, path,
                       seed: int, nr_types: int = 6) -> Dict:
    """The variables of `module` ('kimia', 'hover' or 'efficientnet'): the
    torch checkpoint at `path` when that file exists (the JAX package's
    rule) over the seeded init, whose draws are skipped when the file
    holds every leaf. Prints which weights ran.

    For HoVer-Net the tree holds the decoders `module` has, and fc1 only
    where the file has it and `module` takes it: the init is drawn
    without fc1 (the same draws for every other leaf), and
    `load_hovernet` seeds fc1 on its device."""
    from ... import convert as bridge

    module_nofc1 = module
    if kind == "hover" and module.fc1 is not None:
        module_nofc1 = HoVerNet(nr_types, module.mode, with_fc1=False,
                                branches=module.branches)
    converted, fc1 = {}, None
    if path and os.path.exists(str(path)):
        if kind == "hover":
            converted, fc1 = _read_hovernet(module, path, nr_types)
        elif kind == "kimia":
            converted = convert.load_kimianet(path)
        else:
            converted = convert.efficientnet_torch_to_flax(
                convert.load_torch_state_dict(path),
                num_classes=module.fc.out_features)
        print(f"{kind} weights: {path}", flush=True)
    else:
        why = f"{path} not found" if path else "no weights path set"
        print(f"{kind} weights: seeded init (seed {seed}), {why}", flush=True)
    init = bridge.to_flax_variables(module_nofc1)
    if not _leaf_paths(init) <= _leaf_paths(converted):
        init = _seeded(module_nofc1, seed)
    variables = convert.merge_into(init, converted)
    if fc1 is not None:
        variables["params"]["fc1"] = fc1
    return variables


def _leaf_paths(tree: Dict, prefix: str = "") -> set:
    out = set()
    for k, v in tree.items():
        out |= (_leaf_paths(v, f"{prefix}{k}/") if isinstance(v, dict)
                else {prefix + k})
    return out


def _read_hovernet(module: HoVerNet, path, nr_types: int):
    """A reference HoVer-Net file as (flax tree of the modules `module`
    has, fc1 or None). fc1 is taken only by a module with fc1 (a typing
    net never converts the 4 GB kernel; the JAX package drops it before
    converting, too) and must have its width."""
    sd = convert.strip_dataparallel(convert.load_torch_state_dict(path))
    if module.fc1 is None:
        sd = {k: v for k, v in sd.items() if not k.startswith("fc1.")}
    converted = convert.hovernet_torch_to_flax(sd, nr_types)
    fc1 = converted["params"].pop("fc1", None)
    if fc1 is not None and fc1["kernel"].shape != tuple(module.fc1.kernel.shape):
        raise ValueError(f"fc1 kernel {fc1['kernel'].shape} in {path}, the "
                         f"module takes {tuple(module.fc1.kernel.shape)}")
    keep = {name for name, _ in module.named_children()}
    return {col: {k: v for k, v in tree.items() if k in keep}
            for col, tree in converted.items()}, fc1


def load_hovernet(model: HoVerNet, variables: Dict, seed: int) -> HoVerNet:
    """Copy a flax tree into `model`; fc1 from the tree when it holds one,
    else seeded on fc1's device (`ChunkedDense.seed_`)."""
    from ... import convert as bridge

    for name, child in model.named_children():
        if name == "fc1" and "fc1" not in variables["params"]:
            child.seed_(seed)
            continue
        bridge.load_flax_variables(
            child, {col: tree.get(name, {}) for col, tree in variables.items()})
    return model


def make_hovernet(hovernet_config: Dict, nr_types: int, device: torch.device,
                  variables: Optional[Dict] = None, seed: int = 0,
                  feat_dim: Optional[int] = None) -> HoVerNet:
    """HoVer-Net in eval mode and f32, built on `device`: the typing net
    (encoder + tp) when feat_dim is None, else the full net with fc1 at
    feat_dim. Weights as the module docstring says."""
    mode = hovernet_config.get("mode", "fast")
    with torch.device(device):
        model = (HoVerNet.typing(nr_types, mode) if feat_dim is None
                 else HoVerNet(nr_types, mode, feat_dim=feat_dim))
    if variables is None:
        variables = load_cnn_variables(
            "hover", model, hovernet_config.get("hovernet_model_path"), seed,
            nr_types)
    return load_hovernet(model, variables, seed).eval()


def _card_dtype(model: torch.nn.Module, device: torch.device):
    """(model, input dtype): bf16 weights, channels-last, on the card (the
    TPU branch's choice); f32 on the CPU."""
    if device.type != "cuda":
        return model, torch.float32
    return (model.to(dtype=torch.bfloat16, memory_format=torch.channels_last),
            torch.bfloat16)


def make_hover_typing_device(hovernet_config: Dict, nr_types: int,
                             device: torch.device, variables: Optional[Dict],
                             seed: int):
    """imgs [B, 256, 256, 3] f32 on the device -> node types [B] int32."""
    model, dtype = _card_dtype(
        make_hovernet(hovernet_config, nr_types, device, variables, seed),
        device)

    def typing_dev(imgs):
        return hovernet_typing_apply(model, imgs.to(dtype), nr_types)

    return typing_dev


def make_hover_typing(hovernet_config: Dict, nr_types: int = 6, device=None,
                      variables: Optional[Dict] = None, seed: int = 0
                      ) -> Callable[[np.ndarray], np.ndarray]:
    """The node-typing stage on its own: patches [B, 256, 256, 3] (f32 in
    [0, 1], or uint8) -> node types [B] int32, both numpy. HoVer-Net's
    encoder, tp decoder and majority typing run on `device` (the card
    unless the caller passes "cpu")."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_cuda_numerics()
    typing_dev = make_hover_typing_device(hovernet_config, nr_types, dev,
                                          variables, seed)

    def typing(patches: np.ndarray) -> np.ndarray:
        arr = np.asarray(patches)
        if arr.dtype != np.uint8:
            arr = np.asarray(arr, np.float32)
        with torch.inference_mode():
            imgs = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
            types = typing_dev(_norm_pixels(imgs))
        return types.to(torch.int32).cpu().numpy()

    return typing


def make_cnn_encoder(name: str, config: Dict, hovernet_config: Dict,
                     kimianet_config: Dict, with_typing: bool = False,
                     pad_batch_to: Optional[int] = None, device=None,
                     kimia_variables: Optional[Dict] = None,
                     hover_variables: Optional[Dict] = None,
                     efficientnet_variables: Optional[Dict] = None,
                     seed: int = 0, devices=None,
                     vit_state_dict: Optional[Dict] = None):
    """`(patches [B, 256, 256, 3] uint8 or f32) -> (features [B, D] f32,
    node_types [B] int32 | None)`.

    'kimia' runs the fused KimiaNet (the hand-written dense-layer and
    transition kernels), 'efficientnet-b4' EfficientNet-B4 with its
    feature_dim-way fc, 'uni2-h' the UNI2-h ViT (vit.py: the tiles
    resized to 224 and normalised on the device; feature_dim must be its
    width, 1536; `config['vit']` may set other sizes); with_typing adds
    HoVer-Net typing on the same uploaded chunk. 'hover' runs HoVer-Net
    once for both: fc1 features (feature_dim wide) and types. bf16
    storage on the card, f32 on the CPU. Any other name raises
    NotImplementedError (the JAX package builds no 'efficientnet-b7'
    either). Weights as the module docstring says.

    `devices` (a sequence, or a parallel.Mesh) shards every chunk over
    several devices, one replica of each CNN per distinct device (the
    JAX package's `mesh`; the reference's DataParallel); by default the
    one `device`. The encoder carries the first device's functions as
    `encode.stages` ('kimianet' / 'efficientnet' / 'vit' / 'hovernet'), for
    per-stage timing; while a profiler runs each stage call is a device
    span `encode/<stage>` (profiling.span)."""
    if devices is None:
        devs = (resolve_device(device),)
    else:
        from ...parallel.mesh import _device_list

        devs = tuple(resolve_device(d) for d in _device_list(devices))
    if any(d.type == "cuda" for d in devs):
        set_cuda_numerics()
    nr_types = int(config.get("n_node_type", 6))
    feat_dim = int(config.get("feature_dim", 1024))
    if name not in ("hover", "kimia", "efficientnet-b4", "uni2-h"):
        raise NotImplementedError(f"encoder {name!r}")
    if name == "kimia" and kimia_variables is None:
        kimia_variables = load_cnn_variables(
            "kimia", KimiaNet(), kimianet_config.get("kimianet_model_path"),
            seed + 1)
    stages = {}

    def build(dev):
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        if name == "hover":
            model, _ = _card_dtype(make_hovernet(
                hovernet_config, nr_types, dev, hover_variables, seed,
                feat_dim=feat_dim), dev)

            def full(imgs):
                with span("encode/hovernet", device=dev):
                    return hovernet_full_apply(model, imgs.to(dtype),
                                               nr_types)

            stages.setdefault("hovernet", full)
            return full
        if name == "kimia":
            fp = fuse_kimianet(kimia_variables, dtype=dtype, device=dev)

            def feat_part(imgs):
                with span("encode/kimianet", device=dev):
                    return kimianet_fused_apply(fp, imgs.to(dtype))[0]

            stage = "kimianet"
        elif name == "uni2-h":
            vit = make_vit(dev, dtype, vit_state_dict,
                           config.get("uni2h_model_path"), seed + 3,
                           **config.get("vit", {}))
            width = vit.norm.normalized_shape[0]
            if width != feat_dim:
                raise ValueError(f"uni2-h gives {width} features a patch; "
                                 f"feature_dim is {feat_dim}")

            def feat_part(imgs):
                with span("encode/vit", device=dev):
                    return vit_apply(vit, imgs)

            stage = "vit"
        else:
            model = _efficientnet(name, config, feat_dim, dev,
                                  efficientnet_variables, seed)

            def feat_part(imgs):
                with span("encode/efficientnet", device=dev):
                    return efficientnet_apply(model, imgs.to(dtype))

            stage = "efficientnet"
        stages.setdefault(stage, feat_part)
        if not with_typing:
            return feat_part
        hover_typing = make_hover_typing_device(
            dict(hovernet_config), nr_types, dev, hover_variables, seed)

        def typing_dev(imgs):
            with span("encode/hovernet", device=dev):
                return hover_typing(imgs)

        stages.setdefault("hovernet", typing_dev)
        return lambda imgs: (feat_part(imgs), typing_dev(imgs))

    encode = _make_encode(build, devs, pad_batch_to)
    encode.stages = stages  # normalised device pixels in, device tensors out
    return encode


def _efficientnet(name: str, config: Dict, feat_dim: int, dev: torch.device,
                  variables: Optional[Dict], seed: int):
    """EfficientNet-B4 in eval mode on `dev` (bf16 on the card)."""
    from ... import convert as bridge

    with torch.device(dev):
        model = EfficientNet.from_name(name, num_classes=feat_dim)
    if variables is None:
        variables = load_cnn_variables(
            "efficientnet", model, config.get("efficientnet_model_path"),
            seed + 2)
    return _card_dtype(bridge.load_flax_variables(model, variables).eval(),
                       dev)[0]
