"""The LayerNorm row passes (``csrc/layernorm.cu``) on the CPU: their design,
their wrappers, and the plain versions the kernels are held to on the card.

The forward and the backward pick a branch by the width D: a lane holds
its ceil(D / 256) chunks of 8 values of a row in registers, and a grid of
persistent 4-warp blocks walks the rows ("registers", to D = 1024, both
kinds alike); past that one warp a row sweeps it ("streamed"). Here,
without a card:

* the design helper ``_kernels.row_pass_design``: its branch points for
  both kinds (D = 8, 256, 264, 768, 1024, 1032, 2048, 2056), and at every
  width to 4096 chunks that cover the row and blocks that fit an SM; a
  width that is not a positive multiple of 8 refused;
* the C entries' declarations;
* the three wrappers (``layernorm``, ``layernorm_bwd``, ``row_scale``) on
  fake CUDA tensors (``FakeTensorMode``) with a stand-in library: one call
  of the C entry a call, with the pointers, (rows, D), eps and the stream;
  only the output allocated; the design held to its C twin; one count a
  launch;
* every refusal of the wrappers (a tensor on the CPU or on another device,
  a dtype the kernel does not read, a non-contiguous or misaligned tensor,
  D % 8 != 0, a gamma, beta, dy, g or scale whose shape disagrees with x)
  raises ``ValueError`` before the library is loaded;
* ``layer_norm_fp32`` and ``layer_norm_bwd_plain`` against LayerNorm and
  its gradient in float64 on the same bf16 inputs at D = 8, 200, 768, 1024
  and 2056. They compute in fp32, so they land within a few fp32 ulps of
  the reference: measured max error up to 2.0e-7 of max|ref| (forward) and
  1.5e-7 (backward), mean error up to 8.0e-8 of mean|ref|; bounds 2e-6 and
  5e-7. The unbiased variance (2.3e-4 of max|ref| at D = 2056), a dropped
  beta, or a backward without its mean(dxhat) or mean(dxhat xhat) term
  (1.2e-2 and more) falls outside them.

The kernels themselves are held on the card by ``tests/test_torch_cuda.py::
test_row_passes_match_plain`` and ``chip_smoke.py`` phase 17.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from adapt_image_models_torch import ops
from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import layer_norm_bwd_plain, layer_norm_fp32

# fake CUDA tensors have no storage: their data pointer reads 0 (plus the
# view's offset) with a deprecation warning
pytestmark = pytest.mark.filterwarnings("ignore:Accessing the data pointer")


# ---------------------------------------------------------------------------
# the design


@pytest.mark.parametrize("kind,d,want", [
    ("forward", 8, ("registers", 1, 4, 8)), ("forward", 256, ("registers", 1, 4, 8)),
    ("forward", 264, ("registers", 2, 4, 6)), ("forward", 768, ("registers", 3, 4, 4)),
    ("forward", 1024, ("registers", 4, 4, 3)), ("forward", 1032, ("streamed", 0, 8, 0)),
    ("forward", 2048, ("streamed", 0, 8, 0)), ("forward", 2056, ("streamed", 0, 8, 0)),
    ("backward", 8, ("registers", 1, 4, 8)), ("backward", 256, ("registers", 1, 4, 8)),
    ("backward", 264, ("registers", 2, 4, 6)), ("backward", 768, ("registers", 3, 4, 4)),
    ("backward", 1024, ("registers", 4, 4, 3)), ("backward", 1032, ("streamed", 0, 8, 0)),
    ("backward", 2048, ("streamed", 0, 8, 0)), ("backward", 2056, ("streamed", 0, 8, 0))])
def test_row_pass_design_branch_points(kind, d, want):
    assert _kernels.row_pass_design(kind, d) == want
    assert ops.row_pass_design(kind, d) == want


def test_row_pass_design_covers_every_width():
    """At every width to 4096: a lane's chunks cover the row with one chunk
    to spare at most, and a register grid's blocks fit an SM (2048 threads,
    65536 registers, at least 64 a thread)."""
    for kind in _kernels.ROW_PASS_KINDS:
        for d in range(8, 4097, 8):
            branch, cpl, warps, blocks = _kernels.row_pass_design(kind, d)
            assert branch == ("registers" if d <= 1024 else "streamed"), (kind, d)
            if branch == "registers":
                assert (cpl - 1) * 256 < d <= cpl * 256, (kind, d)
                threads = warps * 32 * blocks
                assert threads <= 2048 and 65536 // threads >= 64, (kind, d)
            else:
                assert (cpl, warps, blocks) == (0, 8, 0)


@pytest.mark.parametrize("kind,d", [("forward", 0), ("forward", 12), ("backward", 770),
                                    ("backward", -8), ("sideways", 768)])
def test_row_pass_design_refuses(kind, d):
    with pytest.raises(ValueError):
        _kernels.row_pass_design(kind, d)


def test_the_c_entries_are_declared():
    """ctypes gets the argument types of the design entry (two ints and a
    pointer to three) and of the two passes, so that it passes every
    pointer whole."""
    P, I, F = _kernels._P, _kernels._I, _kernels._F
    assert _kernels._SIGNATURES["aim_row_pass_design"] == [I, I, P]
    assert _kernels._SIGNATURES["aim_layernorm_bf16"] == [P, P, P, P, I, I, F, P]
    assert _kernels._SIGNATURES["aim_layernorm_bwd_bf16"] == [P, P, P, P, P, I, I, F, P]
    assert _kernels._SIGNATURES["aim_row_scale_bf16"] == [P, P, I, F, P, P, I, I, P]


# ---------------------------------------------------------------------------
# the wrappers


class _FakeLibrary:
    """The row passes' C entries: the design answers its Python twin's
    (blocks an SM plus ``skew``), a launch records its name and arguments
    and returns 0."""

    def __init__(self, skew=0):
        self.launches, self.skew = [], skew

    def aim_row_pass_design(self, kind, d, out):
        branch, *numbers = _kernels.row_pass_design(_kernels.ROW_PASS_KINDS[kind], d)
        out[0], out[1], out[2] = numbers[0], numbers[1], numbers[2] + self.skew
        assert len(out) == 3
        return ("registers", "streamed").index(branch)

    def __getattr__(self, name):
        if not name.startswith("aim_"):
            raise AttributeError(name)

        def launch(*args):
            self.launches.append((name, args))
            return 0
        return launch


class _Allocations(TorchDispatchMode):
    """Records the shape and dtype of every tensor an op creates."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.__name__.split(".")[0] in ("empty", "empty_like", "zeros", "zeros_like",
                                           "new_empty", "empty_strided"):
            self.made.append((tuple(out.shape), out.dtype))
        return out


def _fake(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="cuda")


@pytest.fixture
def fake_library(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(_kernels, "library", lambda: lib)
    monkeypatch.setattr(_kernels, "_stream", lambda: 7)
    monkeypatch.setattr(_kernels, "_designs_held", set())
    ops.reset_launch_counts()
    yield lib
    ops.reset_launch_counts()


@pytest.mark.parametrize("d", [8, 768, 1032, 2056])
def test_wrappers_launch_once_and_allocate_only_their_outputs(fake_library, d):
    """Each wrapper hands its C entry the tensors' pointers (g's null when
    it is not given), (rows, D), eps or the scale's arguments and the
    stream; allocates its output(s) and nothing else; holds its design to
    the C twin; counts one launch a call."""
    rows = 5
    with FakeTensorMode():
        x, res = _fake(rows, d, dtype=torch.bfloat16), _fake(rows, d, dtype=torch.bfloat16)
        w, b, dy, gate = _fake(d), _fake(d), _fake(rows, d), _fake(rows)
        with _Allocations() as alloc:
            y = _kernels.layernorm(x, w, b, eps=1e-6)
            dx = _kernels.layernorm_bwd(x, dy, w, res)
            dx0 = _kernels.layernorm_bwd(x, dy, w)
            o32, o16 = _kernels.row_scale(res, gate, 1, 0.8)
    bf = torch.bfloat16
    assert alloc.made == [((rows, d), bf)] * 3 + [((rows, d), torch.float32), ((rows, d), bf)]
    assert [(t.shape, t.dtype) for t in (y, dx, dx0, o16)] == [((rows, d), bf)] * 4
    assert (o32.shape, o32.dtype) == ((rows, d), torch.float32)
    # a fake tensor's data pointer reads 0, so the arguments name no tensor
    assert fake_library.launches == [
        ("aim_layernorm_bf16", (0, 0, 0, 0, rows, d, 1e-6, 7)),
        ("aim_layernorm_bwd_bf16", (0, 0, 0, 0, 0, rows, d, 1e-5, 7)),
        ("aim_layernorm_bwd_bf16", (0, 0, 0, None, 0, rows, d, 1e-5, 7)),
        ("aim_row_scale_bf16", (0, 0, 1, 0.8, 0, 0, rows, d, 7))]
    assert {("aim_row_pass_design", kind, d) for kind in (0, 1)} == _kernels._designs_held
    assert (_kernels.layernorm.launches, _kernels.layernorm_bwd.launches,
            _kernels.row_scale.launches) == (1, 2, 1)


@pytest.mark.parametrize("kind,d", [(0, 768), (0, 2056), (1, 1024), (1, 1032)])
def test_wrapper_holds_the_c_design_to_its_twin(monkeypatch, kind, d):
    """``_hold_design`` reads the C function's three numbers (kind 0 the
    forward, 1 the backward) and raises where one disagrees."""
    monkeypatch.setattr(_kernels, "_designs_held", set())
    skewed = _FakeLibrary(skew=1)
    monkeypatch.setattr(_kernels, "library", lambda: skewed)
    with pytest.raises(RuntimeError):
        _kernels._hold_design("aim_row_pass_design", kind, d)
    monkeypatch.setattr(_kernels, "library", lambda: _FakeLibrary())
    _kernels._hold_design("aim_row_pass_design", kind, d)
    assert ("aim_row_pass_design", kind, d) in _kernels._designs_held


def _refusals():
    """(label, call) of every input a row-pass wrapper refuses, on fake
    CUDA tensors (CPU ones where the device is the fault)."""
    bf, rows, d = torch.bfloat16, 4, 16
    x, g = _fake(rows, d, dtype=bf), _fake(rows, d, dtype=bf)
    w, b, dy, gate = _fake(d), _fake(d), _fake(rows, d), _fake(2)
    strided = _fake(rows, 2 * d, dtype=bf).as_strided((rows, d), (2 * d, 1))
    shifted = _fake(rows * d + 8, dtype=bf).as_strided((rows, d), (d, 1), 4)
    return [
        ("x on the CPU", lambda: _kernels.layernorm(x.to("cpu"), w, b)),
        ("gamma on the CPU", lambda: _kernels.layernorm(x, torch.ones(d), b)),
        ("g on another device", lambda: _kernels.layernorm_bwd(
            x, dy, w, torch.empty(rows, d, dtype=bf, device="cuda:1"))),
        ("fp32 x", lambda: _kernels.layernorm(x.float(), w, b)),
        ("bf16 gamma", lambda: _kernels.layernorm(x, w.to(bf), b)),
        ("bf16 beta", lambda: _kernels.layernorm(x, w, b.to(bf))),
        ("bf16 gamma, backward", lambda: _kernels.layernorm_bwd(x, dy, w.to(bf))),
        ("bf16 dy", lambda: _kernels.layernorm_bwd(x, dy.to(bf), w)),
        ("fp32 g", lambda: _kernels.layernorm_bwd(x, dy, w, g.float())),
        ("fp32 g of row_scale", lambda: _kernels.row_scale(g.float(), gate, 2)),
        ("bf16 scale", lambda: _kernels.row_scale(g, gate.to(bf), 2)),
        ("non-contiguous x", lambda: _kernels.layernorm(strided, w, b)),
        ("non-contiguous g", lambda: _kernels.layernorm_bwd(x, dy, w, strided)),
        ("non-contiguous g of row_scale", lambda: _kernels.row_scale(strided, gate, 2)),
        ("misaligned x", lambda: _kernels.layernorm(shifted, w, b)),
        ("misaligned dy", lambda: _kernels.layernorm_bwd(
            x, _fake(rows * d + 2).as_strided((rows, d), (d, 1), 2), w)),
        ("misaligned gamma", lambda: _kernels.layernorm(x, _fake(d + 1).as_strided((d,), (1,), 1),
                                                        b)),
        ("D % 8", lambda: _kernels.layernorm(_fake(rows, 12, dtype=bf), _fake(12), _fake(12))),
        ("D % 8, backward", lambda: _kernels.layernorm_bwd(_fake(rows, 12, dtype=bf),
                                                          _fake(rows, 12), _fake(12))),
        ("D % 8, row_scale", lambda: _kernels.row_scale(_fake(rows, 12, dtype=bf), gate, 2)),
        ("x not 2-D", lambda: _kernels.layernorm(_fake(2, rows, d, dtype=bf), w, b)),
        ("gamma of another width", lambda: _kernels.layernorm(x, _fake(2 * d), b)),
        ("beta of another width", lambda: _kernels.layernorm(x, w, _fake(d - 8))),
        ("dy of another shape", lambda: _kernels.layernorm_bwd(x, _fake(rows + 1, d), w)),
        ("g of another shape", lambda: _kernels.layernorm_bwd(
            x, dy, w, _fake(rows, 2 * d, dtype=bf))),
        ("scale of another length", lambda: _kernels.row_scale(g, _fake(3), 2)),
        ("no rows a scale", lambda: _kernels.row_scale(g, gate, 0)),
    ]


def test_wrappers_refuse_before_loading_the_library(monkeypatch):
    def no_library():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(_kernels, "library", no_library)
    with FakeTensorMode(allow_non_fake_inputs=True):
        refusals = _refusals()
        assert len(refusals) == 27
        for label, call in refusals:
            with pytest.raises(ValueError):
                call()
                pytest.fail(label)


# ---------------------------------------------------------------------------
# the plain versions against float64


# (max, mean) error bounds of the plain versions, relative to max|ref| and
# mean|ref| (the module docstring has the measured errors)
PLAIN_BOUNDS = (2e-6, 5e-7)


def _within(got, want):
    err = (got - want).abs()
    return bool(err.max() <= PLAIN_BOUNDS[0] * want.abs().max()
                and err.mean() <= PLAIN_BOUNDS[1] * want.abs().mean())


def _ln64(x, w, b, eps=1e-5, unbiased=False):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().sum(-1, keepdim=True) / (x.shape[-1] - unbiased)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _ln_bwd64(x, dy, w, g=None, eps=1e-5, drop=None):
    """dx of LayerNorm in float64: rstd (dxhat - mean(dxhat) - xhat
    mean(dxhat xhat)) + g; ``drop`` leaves out "mdx" or "mdxx"."""
    mean = x.mean(-1, keepdim=True)
    rstd = 1 / torch.sqrt((x - mean).square().mean(-1, keepdim=True) + eps)
    xhat, dxhat = (x - mean) * rstd, dy * w
    mdx = 0 if drop == "mdx" else dxhat.mean(-1, keepdim=True)
    mdxx = 0 if drop == "mdxx" else (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd * (dxhat - mdx - xhat * mdxx)
    return dx if g is None else dx + g


@pytest.mark.parametrize("d", [8, 200, 768, 1024, 2056])
def test_plain_row_passes_against_float64(d):
    """``layer_norm_fp32`` and ``layer_norm_bwd_plain`` (with and without g)
    on 33 bf16 rows off centre against float64, within PLAIN_BOUNDS; the
    unbiased variance, a dropped beta and a backward without either mean
    term fall outside them."""
    rng = np.random.default_rng(1400 + d)
    x = torch.from_numpy(0.5 + rng.standard_normal((33, d))).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((33, d))).to(torch.bfloat16)
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(d)).float()
    b = torch.from_numpy(0.1 * rng.standard_normal(d)).float()
    dy = torch.from_numpy(rng.standard_normal((33, d))).float()
    x64, g64, w64, b64, dy64 = (t.double() for t in (x, g, w, b, dy))

    want = _ln64(x64, w64, b64)
    assert _within(layer_norm_fp32(x, w, b).double(), want)
    assert not _within(_ln64(x64, w64, b64, unbiased=True), want)
    assert not _within(_ln64(x64, w64, 0 * b64), want)

    for res in (None, g64):
        want = _ln_bwd64(x64, dy64, w64, res)
        got = layer_norm_bwd_plain(x, dy, w, None if res is None else g).double()
        assert _within(got, want), res is None
        for drop in ("mdx", "mdxx"):
            assert not _within(_ln_bwd64(x64, dy64, w64, res, drop=drop), want), drop
