"""HoVer-Net's one-pass BatchNorm + ReLU (wsi_hgnn_tpu_torch/kernels/hovernet.py)
and its padding in the convolutions, on the CPU: the wrapper's plain
version is the unfused ops bit for bit in all three forms; the typing net
that pads its stride-1 convolutions itself equals the route through
`tf_same_pad` copies; the card path's argument checks raise without a
card (meta operands, stand-ins for the launch)."""
import copy
import types

import pytest
import torch
import torch.nn.functional as F
from torch import nn

import port_threads  # noqa: F401  (torch threads per test worker)
from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch.kernels import hovernet as ba
from wsi_hgnn_tpu_torch.models.featurizers import hovernet as thv

DTYPES = (torch.float32, torch.bfloat16)
# (channels, size): a d0 crop, a dense-block concat width, a d3-wide map
SHAPES = ((64, 164), (288, 62), (1024, 46))


def _bn(ch, dtype, seed):
    """An eval BatchNorm with non-trivial weight, bias and statistics."""
    g = torch.Generator().manual_seed(seed)
    bn = nn.BatchNorm2d(ch, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(ch, generator=g) * 2 - 0.5)
        bn.bias.copy_(torch.randn(ch, generator=g))
        bn.running_mean.copy_(torch.randn(ch, generator=g))
        bn.running_var.copy_(torch.rand(ch, generator=g) * 3 + 0.01)
    return bn.eval().to(dtype)


def _map(ch, size, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(2, ch, size, size, generator=g) * 2).to(dtype) \
        .contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("ch,size", SHAPES)
@pytest.mark.parametrize("form", ["bn_relu", "add_keep_sum", "add"])
def test_plain_version_is_the_unfused_ops(dtype, ch, size, form):
    """bn_act on a CPU tensor (and BNRelu) is F.relu(bn(x)) and h + r bit
    for bit, on channels-last maps."""
    bn = _bn(ch, dtype, seed=ch)
    h = _map(ch, size, dtype, seed=1)
    r = None if form == "bn_relu" else _map(ch, size, dtype, seed=2)
    keep = form == "add_keep_sum"
    before = ba.bn_act.launches
    with torch.inference_mode():
        s = h if r is None else h + r
        want = F.relu(bn(s))
        got = ba.bn_act(h, bn, r, keep_sum=keep)
        unit = thv.BNRelu(ch).to(dtype).eval()
        unit.bn = bn
        mod = unit(h, r, keep_sum=keep)
    assert ba.bn_act.launches == before      # the plain path counts none
    for out in (got, mod):
        if keep:
            assert torch.equal(out[0], s) and out[0].dtype == dtype
            out = out[1]
        assert out.dtype == dtype and torch.equal(out, want)


def _seeded_typing(seed=3):
    """The typing net with seeded weights and jittered running stats, so
    every BatchNorm is non-trivial."""
    model = convert.init_flax_like_(thv.HoVerNet.typing(6, "fast"), seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=g)
                                     * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=g)
                                    + 0.5)
    return model.eval()


class _PadThenConv(nn.Module):
    """The tf_same_pad route: a padded copy, then the unpadded conv."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        self.k = conv.kernel_size[0]
        self.conv = copy.deepcopy(conv)
        self.conv.padding = (0, 0)

    def forward(self, x):
        return self.conv(thv.tf_same_pad(x, self.k, 1))


def _tf_same_pad_route(model):
    """A copy of `model` whose self-padding convolutions pad with
    tf_same_pad copies instead, as the net did before they padded
    themselves."""
    route = copy.deepcopy(model)
    for owner in list(route.modules()):
        for name, child in list(owner.named_children()):
            if isinstance(child, nn.Conv2d) and child.padding != (0, 0):
                setattr(owner, name, _PadThenConv(child))
    return route


def test_padding_moved_into_the_convolutions():
    """conv0, the 13 stride-1 residual conv2s and u1_conva pad themselves
    (symmetric TF-same pads); the three stride-2 first units do not."""
    model = thv.HoVerNet.typing(6, "fast")
    padded = [n for n, m in model.named_modules()
              if isinstance(m, nn.Conv2d) and m.padding != (0, 0)]
    assert len(padded) == 15
    assert "conv0" in padded and "decoder_tp.u1_conva" in padded
    for blk in ("d1", "d2", "d3"):
        conv = getattr(model, blk).u0_conv2
        assert conv.stride == (2, 2) and conv.padding == (0, 0)
    assert thv.HoVerNet.typing(6, "original").conv0.padding == (0, 0)
    assert all(isinstance(m, thv.BNRelu) for n, m in model.named_modules()
               if n.endswith(("preact", "bn0", "bn1", "bn2", "blk_bna",
                              "u0_bn")))
    assert sum(isinstance(m, thv.BNRelu) for m in model.modules()) == 76


def test_typing_with_padding_in_convolutions_matches_tf_same_pad_route():
    """The typing net as it runs (pads in the convolutions, the residual
    sums made in the BatchNorm pass) against the tf_same_pad route with
    the unfused ops, f32 on the CPU: tp logits to rtol 1e-6, the same node
    types."""
    model = _seeded_typing()
    route = _tf_same_pad_route(model)
    x = torch.rand(1, 256, 256, 3, generator=torch.Generator().manual_seed(4))
    xt = thv._nchw(thv._constructor_orientation(x))
    with torch.inference_mode():
        got = model.decode_branch("tp", model.encode(xt))
        want = route.decode_branch("tp", route.encode(xt))
        assert got.shape == (1, 6, 164, 164)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        assert torch.equal(thv.hovernet_typing_apply(model, x),
                           thv.hovernet_typing_apply(route, x))


# ---------------------------------------------------------------------------
# the card path's checks, without a card
# ---------------------------------------------------------------------------
@pytest.fixture()
def fake_launch(monkeypatch):
    """Meta operands reach the card path; the C entry and the stream are
    stand-ins that record each launch's arguments."""
    calls = []

    def entry(suffix):
        def fn(*args):
            calls.append((suffix, args))
            return 0
        return fn

    class device:
        def __init__(self, d):
            pass

        def __enter__(self):
            pass

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(ba, "_kernel", entry)
    return calls


def _meta(ch=64, size=8, dtype=torch.bfloat16, channels_last=True):
    x = torch.empty(2, ch, size, size, dtype=dtype, device="meta")
    return x.contiguous(memory_format=torch.channels_last) if channels_last \
        else x


def _meta_bn(ch=64, dtype=torch.bfloat16):
    return nn.BatchNorm2d(ch).to(device="meta", dtype=dtype).eval()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_card_path_launches_each_form_once(fake_launch, dtype):
    """One launch a call: the sum pointer only with a residual, the sum
    buffer only when kept; rows = N*H*W; the counter counts each."""
    bn, x, r = _meta_bn(dtype=dtype), _meta(dtype=dtype), _meta(dtype=dtype)
    before = ba.bn_act.launches
    with torch.inference_mode():
        y = ba.bn_act(x, bn)
        s2, y2 = ba.bn_act(x, bn, r, keep_sum=True)
        y3 = ba.bn_act(x, bn, r)
    assert ba.bn_act.launches == before + 3
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    assert [c[0] for c in fake_launch] == [suffix] * 3
    (_, a1), (_, a2), (_, a3) = fake_launch
    assert a1[1] is None and a1[2] is None          # relu(bn(x))
    assert a2[1] is not None and a2[2] is not None  # sum kept
    assert a3[1] is not None and a3[2] is None      # sum dropped
    assert all(a[9:11] == (2 * 8 * 8, 64) for a in (a1, a2, a3))
    for t in (y, s2, y2, y3):
        assert t.shape == x.shape and t.dtype == dtype
        assert t.is_contiguous(memory_format=torch.channels_last)


def test_card_path_raises_on_a_map_that_is_not_channels_last(fake_launch):
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="channels-last"):
        ba.bn_act(_meta(channels_last=False), _meta_bn())
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="channels-last"):
        ba.bn_act(_meta(), _meta_bn(), _meta(channels_last=False))
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="channels-last"):
        ba.bn_act(_meta(size=10)[:, :, 1:9, 1:9], _meta_bn())
    assert not fake_launch


def test_card_path_raises_on_a_batchnorm_in_training_mode(fake_launch):
    with torch.inference_mode(), pytest.raises(ValueError, match="eval"):
        ba.bn_act(_meta(), _meta_bn().train())
    assert not fake_launch


def test_card_path_raises_on_an_operand_that_needs_a_gradient(fake_launch):
    """With autograd on: a map that requires grad, or the BatchNorm's own
    parameters (they require grad as module parameters do)."""
    bn = _meta_bn()
    x = _meta().requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        ba.bn_act(x, bn)
    with pytest.raises(ValueError, match="no backward"):
        ba.bn_act(_meta(), bn)
    with torch.no_grad():
        ba.bn_act(_meta(), bn)                 # frozen: launches
    assert len(fake_launch) == 1


def test_card_path_raises_on_ragged_channel_rows(fake_launch):
    """A channel row must be whole 16-byte vectors (8 bf16, 4 f32)."""
    with torch.inference_mode(), pytest.raises(ValueError, match="16-byte"):
        ba.bn_act(_meta(ch=60), _meta_bn(60))
    with torch.inference_mode():
        ba.bn_act(_meta(ch=60, dtype=torch.float32),
                  _meta_bn(60, torch.float32))
    assert len(fake_launch) == 1


def test_typing_forward_launches_76_on_the_card_path(fake_launch,
                                                     monkeypatch):
    """The typing net on meta operands takes the card path: 76 launches a
    forward (every BNRelu; the 16 residual sums inside them), none for
    the stride-1 pads. Meta convolutions do not keep channels-last, so the
    layout check is left to the next test."""
    pads = []
    real_pad = thv.tf_same_pad
    monkeypatch.setattr(thv, "tf_same_pad",
                        lambda x, k, s: pads.append(s) or real_pad(x, k, s))
    monkeypatch.setattr(ba, "_require", lambda cond, what: None)
    model = thv.HoVerNet.typing(6, "fast").to(
        device="meta", dtype=torch.bfloat16,
        memory_format=torch.channels_last).eval()
    x = _meta(ch=3, size=256)
    before = ba.bn_act.launches
    with torch.inference_mode():
        tp = model.decode_branch("tp", model.encode(x))
    assert tp.shape == (2, 6, 164, 164)
    assert ba.bn_act.launches - before == 76 == len(fake_launch)
    assert sum(a[1] is not None for _, a in fake_launch) == 16
    assert sum(a[2] is not None for _, a in fake_launch) == 12
    assert pads == [2, 2, 2]


def test_typing_forward_hands_bn_act_channels_last_maps():
    """Every map the typing net hands bn_act (BatchNorm inputs and
    residuals) is contiguous channels-last when the input and weights are,
    as on the card: convolutions, residual sums and the dense blocks'
    concatenations of cropped maps all keep the layout."""
    model = _seeded_typing().to(memory_format=torch.channels_last)
    seen = []

    def record(_, args, kwargs):
        for t in (*args, kwargs.get("residual")):
            if isinstance(t, torch.Tensor):
                seen.append(t.is_contiguous(memory_format=torch.channels_last))

    for m in model.modules():
        if isinstance(m, thv.BNRelu):
            m.register_forward_pre_hook(record, with_kwargs=True)
    x = torch.rand(1, 3, 256, 256, generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        model.decode_branch("tp", model.encode(
            x.contiguous(memory_format=torch.channels_last)))
    assert len(seen) == 76 + 16 and all(seen)
