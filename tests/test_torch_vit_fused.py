"""UNI2-h's one-pass block kernels (wsi_hgnn_tpu_torch/kernels/vit.py:
`swiglu`, `add_layer_norm`) and the ViT's launch order built on them, on
the CPU: each plain version is the unfused ops it replaces, bit for bit;
the restructured `ViT.forward` equals the per-block forward it replaced
bit for bit in f32; the card path's argument checks and launch counts run
on meta operands with stand-ins for the launch (no card here)."""
import types

import pytest
import torch
import torch.nn.functional as F
from torch import nn

import port_threads  # noqa: F401  (torch threads per test worker)
from wsi_hgnn_tpu_torch import kernels
from wsi_hgnn_tpu_torch.kernels import vit as kv
from wsi_hgnn_tpu_torch.models.featurizers import vit as tvit

TINY = dict(img_size=56, patch_size=14, embed_dim=96, depth=2, num_heads=4,
            mlp_hidden=256, reg_tokens=8)
DTYPES = (torch.float32, torch.bfloat16)


def _randn(*shape, seed, dtype=torch.float32, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * scale).to(dtype)


def _norm(d, dtype, seed):
    """A LayerNorm with non-trivial weight and bias, eps as UNI2-h's."""
    norm = nn.LayerNorm(d, eps=tvit.LN_EPS)
    with torch.no_grad():
        norm.weight.copy_(_randn(d, seed=seed) * 0.5 + 1.0)
        norm.bias.copy_(_randn(d, seed=seed + 1) * 0.1)
    return norm.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 17, 256), (265, 8192), (5, 16)])
def test_swiglu_plain_version_is_the_unfused_ops(dtype, shape):
    """swiglu on a CPU tensor is F.silu of fc1's first half times its
    second, bit for bit; the plain path counts no launch."""
    h = _randn(*shape, seed=shape[-1], dtype=dtype, scale=3.0)
    before = kv.swiglu.launches
    with torch.inference_mode():
        got = kv.swiglu(h)
        a, b = h.chunk(2, dim=-1)
        want = F.silu(a) * b
    assert kv.swiglu.launches == before
    assert got.dtype == dtype and got.shape == (*shape[:-1], shape[-1] // 2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("branch_dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("form", ["update_and_norm", "norm_alone",
                                  "update_alone"])
@pytest.mark.parametrize("d", [96, 1536])
def test_add_layer_norm_plain_version_is_the_unfused_ops(branch_dtype, form,
                                                         d):
    """add_layer_norm on a CPU stream is torch.addcmul(x, gamma, branch)
    (in place) and norm(x.to(the norm's dtype)), bit for bit, in each
    form: an f32 stream with f32 or bf16 branches, LayerScale and norm."""
    x = _randn(2, 9, d, seed=d, scale=2.0)
    gamma = _randn(d, seed=d + 1, dtype=branch_dtype, scale=0.2)
    branch = _randn(2, 9, d, seed=d + 2, dtype=branch_dtype)
    norm = _norm(d, branch_dtype, seed=d + 3)
    use_branch = form != "norm_alone"
    use_norm = form != "update_alone"
    want_x = torch.addcmul(x, gamma, branch) if use_branch else x.clone()
    with torch.inference_mode():
        want_y = norm(want_x.to(branch_dtype)) if use_norm else None
        stream = x.clone()
        before = kv.add_layer_norm.launches
        got_y = kv.add_layer_norm(stream, gamma if use_branch else None,
                                  branch if use_branch else None,
                                  norm if use_norm else None)
    assert kv.add_layer_norm.launches == before
    assert stream.dtype == torch.float32 and torch.equal(stream, want_x)
    if use_norm:
        assert got_y.dtype == branch_dtype and torch.equal(got_y, want_y)
    else:
        assert got_y is None


def _parent_forward(model: tvit.ViT, x: torch.Tensor) -> torch.Tensor:
    """The ViT's forward before the one-pass kernels: per block, two
    addcmul updates of the f32 stream, each LayerNorm on its cast, SiLU
    and the gate's product as two ops."""
    h = model.patch_embed.proj(x).flatten(2).transpose(1, 2).float()
    h = h + model.pos_embed.float()
    b = h.shape[0]
    h = torch.cat([model.cls_token.float().expand(b, -1, -1),
                   model.reg_token.float().expand(b, -1, -1), h], dim=1)
    for blk in model.blocks:
        dt = blk.norm1.weight.dtype
        h = torch.addcmul(h, blk.ls1.gamma, blk.attn(blk.norm1(h.to(dt))))
        a, g = blk.mlp.fc1(blk.norm2(h.to(dt))).chunk(2, dim=-1)
        h = torch.addcmul(h, blk.ls2.gamma, blk.mlp.fc2(F.silu(a) * g))
    return F.layer_norm(h[:, 0], model.norm.normalized_shape,
                        model.norm.weight.float(), model.norm.bias.float(),
                        model.norm.eps)


def _seeded_tiny(**sizes):
    """TINY's ViT, seeded, with LayerScale and the norms moved off their
    init (1e-5, 1 and 0) so every term of a block counts."""
    model = tvit.seed_(tvit.ViT(**{**TINY, **sizes}), 4)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                p.copy_(0.2 * torch.exp(0.1 * torch.randn(p.shape,
                                                          generator=g)))
            elif "norm" in name or name in ("cls_token", "reg_token"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return model.eval()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_vit_forward_equals_the_per_block_forward_bit_for_bit(depth):
    """The restructured forward (each block's norm1 made by the previous
    launch, the stream updated in place) against the forward it replaced,
    f32 on the CPU: equal bit for bit, and the input image untouched."""
    model = _seeded_tiny(depth=depth)
    x = _randn(3, 3, 56, 56, seed=6)
    x0 = x.clone()
    with torch.inference_mode():
        got = model(x)
        want = _parent_forward(model, x)
    assert got.shape == (3, 96) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(x, x0)


def test_vit_launch_order_per_chunk(monkeypatch):
    """One forward calls add_layer_norm 1 + 2 x depth times and swiglu
    depth times: the LayerNorm alone first (block 0's norm1), then per
    block the update with norm2, and the update with the next block's
    norm1, the last block's second update alone."""
    model = _seeded_tiny(depth=3)
    calls = []
    aln, sg = tvit.add_layer_norm, tvit.swiglu

    def spy_aln(x, gamma, branch, norm):
        calls.append(("add_layer_norm", branch is not None,
                      next((n for n, m in model.named_modules()
                            if m is norm), None)))
        return aln(x, gamma, branch, norm)

    def spy_sg(h):
        calls.append(("swiglu",))
        return sg(h)

    monkeypatch.setattr(tvit, "add_layer_norm", spy_aln)
    monkeypatch.setattr(tvit, "swiglu", spy_sg)
    with torch.inference_mode():
        model(_randn(2, 3, 56, 56, seed=7))
    want = [("add_layer_norm", False, "blocks.0.norm1")]
    for i in range(3):
        nxt = f"blocks.{i + 1}.norm1" if i < 2 else None
        want += [("add_layer_norm", True, f"blocks.{i}.norm2"), ("swiglu",),
                 ("add_layer_norm", True, nxt)]
    assert calls == want


# ---------------------------------------------------------------------------
# the card path's checks and counts, without a card
# ---------------------------------------------------------------------------
@pytest.fixture()
def fake_launch(monkeypatch):
    """Meta operands reach the card path; the C entries and the stream are
    stand-ins that record each launch's arguments."""
    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, args))
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
    monkeypatch.setattr(kv, "_kernel", entry)
    return calls


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _meta_norm(d):
    return nn.LayerNorm(d, eps=tvit.LN_EPS).to(device="meta",
                                                dtype=torch.bfloat16)


def test_card_path_swiglu_launches_once(fake_launch):
    """One launch a call, rows = the leading dimensions' product, the
    half width f; the output [..., f] bf16."""
    h = _meta(4, 265, 8192)
    before = kv.swiglu.launches
    with torch.inference_mode():
        out = kv.swiglu(h)
    assert kv.swiglu.launches == before + 1
    assert out.shape == (4, 265, 4096) and out.dtype == torch.bfloat16
    ((name, args),) = fake_launch
    assert name == "vit_swiglu_bf16" and args[2:4] == (4 * 265, 4096)


@pytest.mark.parametrize("form", ["update_and_norm", "norm_alone",
                                  "update_alone"])
def test_card_path_add_layer_norm_passes_its_form(fake_launch, form):
    """The branch and LayerScale pointers only with a branch, the norm's
    and the output's only with a norm; eps the norm's; one launch."""
    x = _meta(2, 265, 1536, dtype=torch.float32)
    use_branch = form != "norm_alone"
    use_norm = form != "update_alone"
    norm = _meta_norm(1536) if use_norm else None
    before = kv.add_layer_norm.launches
    with torch.inference_mode():
        y = kv.add_layer_norm(x, _meta(1536) if use_branch else None,
                              _meta(2, 265, 1536) if use_branch else None,
                              norm)
    assert kv.add_layer_norm.launches == before + 1
    ((name, args),) = fake_launch
    assert name == "vit_add_layer_norm"
    assert [a is not None for a in args[1:6]] == [
        use_branch, use_branch, use_norm, use_norm, use_norm]
    assert args[7:9] == (2 * 265, 1536)
    if use_norm:
        assert args[6] == pytest.approx(tvit.LN_EPS)
        assert y.shape == x.shape and y.dtype == torch.bfloat16
    else:
        assert y is None


def _bad_swiglu_inputs():
    return {
        "f32 input": _meta(4, 64, dtype=torch.float32),
        "odd width": _meta(4, 63),
        "halves not 16-byte rows": _meta(4, 24),
        "not contiguous": _meta(64, 4).t(),
        "misaligned": _meta(4 * 64 + 1)[1:].view(4, 64),
    }


@pytest.mark.parametrize("case", list(_bad_swiglu_inputs()))
def test_card_path_swiglu_refuses(fake_launch, case):
    h = _bad_swiglu_inputs()[case]
    with torch.inference_mode(), pytest.raises(ValueError):
        kv.swiglu(h)
    assert not fake_launch


def test_card_path_refuses_operands_that_need_a_gradient(fake_launch):
    """Outside inference mode or no_grad, an operand that needs a
    gradient is refused; under no_grad it is taken."""
    h = _meta(4, 64).requires_grad_()
    x = _meta(4, 96, dtype=torch.float32)
    norm = _meta_norm(96)        # its parameters need gradients
    with pytest.raises(ValueError, match="backward"):
        kv.swiglu(h)
    with pytest.raises(ValueError, match="backward"):
        kv.add_layer_norm(x, None, None, norm)
    assert not fake_launch
    with torch.no_grad():
        kv.swiglu(h)
        kv.add_layer_norm(x, None, None, norm)
    assert len(fake_launch) == 2


def _bad_add_ln(case):
    """(x, gamma, branch, norm) for each refused case."""
    f32 = torch.float32
    x, g, r, n = _meta(2, 96, dtype=f32), _meta(96), _meta(2, 96), \
        _meta_norm(96)
    return {
        "bf16 stream": (_meta(2, 96), g, r, n),
        "f32 branch": (x, g, _meta(2, 96, dtype=f32), n),
        "f32 LayerScale": (x, _meta(96, dtype=f32), r, n),
        "f32 norm": (x, g, r, nn.LayerNorm(96).to("meta")),
        "width not 16-byte rows": (_meta(2, 92, dtype=f32), _meta(92),
                                   _meta(2, 92), _meta_norm(92)),
        "branch of another shape": (x, g, _meta(3, 96), n),
        "norm of another width": (x, g, r, _meta_norm(48)),
        "no branch and no norm": (x, None, None, None),
        "branch without LayerScale": (x, None, r, n),
        "misaligned stream": (_meta(2 * 96 + 1, dtype=f32)[1:].view(2, 96),
                              g, r, n),
        "stream not contiguous": (_meta(96, 2, dtype=f32).t(), g, r, n),
        "too wide": (_meta(2, 4104, dtype=f32), None, None,
                     _meta_norm(4104)),
    }[case]


@pytest.mark.parametrize("case", [
    "bf16 stream", "f32 branch", "f32 LayerScale", "f32 norm",
    "width not 16-byte rows", "branch of another shape",
    "norm of another width", "no branch and no norm",
    "branch without LayerScale", "misaligned stream",
    "stream not contiguous", "too wide"])
def test_card_path_add_layer_norm_refuses(fake_launch, case):
    with torch.inference_mode(), pytest.raises(ValueError):
        kv.add_layer_norm(*_bad_add_ln(case))
    assert not fake_launch


def test_uni2h_chunk_launch_counts_at_the_published_widths(fake_launch):
    """UNI2-h at the model card's widths on meta operands (bf16 weights,
    the f32 stream): a 4-image forward makes 24 swiglu launches and
    1 + 24 x 2 add_layer_norm launches, in the block order, and no
    others of the port's kernels."""
    with torch.device("meta"):
        model = tvit.ViT().to(torch.bfloat16).eval()
    kernels.reset_launch_counts()
    with torch.inference_mode():
        out = model(_meta(4, 3, 224, 224))
    assert out.shape == (4, 1536) and out.dtype == torch.float32
    assert kernels.launch_counts() == {
        "knn_l2_fused": 0, "dense_layer_fused": 0, "transition_fused": 0,
        "bn_act": 0, "swiglu": 24, "add_layer_norm": 49}
    names = [n for n, _ in fake_launch]
    assert names == (["vit_add_layer_norm"]
                     + ["vit_add_layer_norm", "vit_swiglu_bf16",
                        "vit_add_layer_norm"] * 24)
    rows = {args[-3] if n == "vit_add_layer_norm" else args[2]
            for n, args in fake_launch}
    assert rows == {4 * 265}
