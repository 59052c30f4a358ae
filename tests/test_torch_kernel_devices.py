"""Every ctypes launch of the DenseNet kernels and of bn_act runs with the
operands' card as the CUDA runtime's current device
(wsi_hgnn_tpu_torch/kernels/densenet.py, hovernet.py), as the KNN's does: the C
entries set their attributes and launch on the current device, so on a
host of several cards a launch for operands on cuda:1 while cuda:0 is
current would go to the wrong card. No card here: the operands are meta
tensors (shapes only), `torch.cuda.device` and the C entries are stand-ins
that record which device was current at each launch."""
import types

import pytest
import torch

import port_threads  # noqa: F401  (torch threads per test worker)
from wsi_hgnn_tpu_torch.kernels import densenet as dn


@pytest.fixture()
def fake_cuda(monkeypatch):
    """(launches [(entry, current device)], the current device stack)."""
    current = ["cuda:0"]
    launches = []

    class device:   # torch.cuda.device's context protocol
        def __init__(self, d):
            self.d = str(d)

        def __enter__(self):
            current.append(self.d)

        def __exit__(self, *exc):
            current.pop()

    def entry(name):
        def fn(*args):
            launches.append((name, current[-1]))
            return 0
        return fn

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(dn, "_kernel", lambda name, suffix: entry(name))
    monkeypatch.setattr(dn, "_cuda_args", lambda x, floats, typed: "bf16")
    return launches, current


def test_dense_layer_launches_on_the_operands_card(fake_cuda):
    launches, current = fake_cuda
    meta = dict(device="meta")
    x = torch.empty(2, 8, 8, 256, dtype=torch.bfloat16, **meta)
    f32 = dict(dtype=torch.float32, **meta)
    dn.dense_layer_fused(
        x, torch.empty(1, 256, **f32), torch.empty(1, 256, **f32),
        torch.empty(256, 128, dtype=torch.bfloat16, **meta),
        torch.empty(1, 128, **f32),
        torch.empty(128, 288, dtype=torch.bfloat16, **meta),
        n_active_groups=2, slot=2)
    assert launches == [("dense_layer", "meta")]
    assert current == ["cuda:0"]


def test_transition_launches_on_the_operands_card(fake_cuda):
    launches, current = fake_cuda
    meta = dict(device="meta")
    x = torch.empty(2, 8, 8, 256, dtype=torch.bfloat16, **meta)
    f32 = dict(dtype=torch.float32, **meta)
    dn.transition_fused(x, torch.empty(1, 256, **f32),
                        torch.empty(1, 256, **f32),
                        torch.empty(256, 128, dtype=torch.bfloat16, **meta))
    assert launches == [("transition", "meta")]
    assert current == ["cuda:0"]


def test_bn_act_launches_on_the_operands_card(fake_cuda, monkeypatch):
    from wsi_hgnn_tpu_torch.kernels import hovernet as kh

    launches, current = fake_cuda
    monkeypatch.setattr(kh, "_kernel",
                        lambda suffix: lambda *args: launches.append(
                            ("bn_act", current[-1])) or 0)
    x = torch.empty(2, 64, 8, 8, dtype=torch.bfloat16, device="meta"
                    ).contiguous(memory_format=torch.channels_last)
    bn = torch.nn.BatchNorm2d(64).to(device="meta",
                                     dtype=torch.bfloat16).eval()
    with torch.inference_mode():
        kh.bn_act(x, bn, x, keep_sum=True)
    assert launches == [("bn_act", "meta")]
    assert current == ["cuda:0"]
