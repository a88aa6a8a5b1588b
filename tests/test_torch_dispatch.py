"""The port's kernel registry (``repro_torch.kernels.dispatch``), re-stating
``tests/test_kernel_dispatch.py``: resolution order (explicit > the
engine's scope > ``REPRO_KERNEL_BACKEND`` > the device), unknown op and
tier errors naming what is registered, shadowing and pad-convention
conflicts refused, the spec registry enumerated; and the W8A8 op's
``a_zero_point`` branch, bit-equal on the CPU to the JAX op's ``xla`` tier
at float32, with its ``quantize_out`` refusal."""
import numpy as np
import pytest

import jax.numpy as jnp

import torch

from repro.kernels.qmatmul_w8a8.ops import qmatmul_w8a8 as jax_qmatmul_w8a8
from repro_torch.kernels import dispatch, serving_kernel_specs
from repro_torch.kernels.dispatch import (
    ENV_VAR,
    TIERS,
    _pad_to,
    register_impl,
    register_spec,
    resolve,
    tier_scope,
)
from repro_torch.kernels.qmatmul_w8a8 import qmatmul_w8a8

CPU = torch.zeros(1)


@pytest.fixture(autouse=True)
def _pristine_registry():
    """Scrub every dummy ``_t_*`` registration on the way out."""
    yield
    for d in (dispatch._REGISTRY, dispatch._PAD, dispatch._SPECS,
              dispatch._LAUNCHES):
        for op in [op for op in d if op.startswith("_t_")]:
            del d[op]


def _register_dummy(op, tiers=TIERS, pad=None):
    for t in tiers:
        @register_impl(op, t, pad=pad)
        def impl(*a, _t=t, **kw):
            return _t


# ------------------------------------------------------------ resolution

def test_explicit_backend_wins_over_env(monkeypatch):
    _register_dummy("_t_explicit", tiers=("torch",))
    monkeypatch.setenv(ENV_VAR, "cuda")
    assert resolve("_t_explicit", CPU, "torch")() == "torch"


def test_env_override_wins_over_device(monkeypatch):
    _register_dummy("_t_env")
    monkeypatch.setenv(ENV_VAR, "torch")
    assert resolve("_t_env", CPU)() == "torch"
    monkeypatch.setenv(ENV_VAR, "cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        resolve("_t_env", CPU)
    monkeypatch.delenv(ENV_VAR)
    # no env, no explicit: the device's tier (the plain version on a CPU)
    assert resolve("_t_env", CPU)() == dispatch.tier_for(CPU) == "torch"


def test_env_reads_the_jax_tier_names(monkeypatch):
    """The JAX package's tier names in ``REPRO_KERNEL_BACKEND`` are meant
    for that package and read as unset: the device picks the tier, so a
    CPU tensor takes the plain version and none of them can put the plain
    versions on the card."""
    _register_dummy("_t_alias")
    for name in ("pallas", "xla", "interpret", "ref"):
        monkeypatch.setenv(ENV_VAR, name)
        assert resolve("_t_alias", CPU)() == "torch"
        assert dispatch.active_tier(CPU) == dispatch.tier_for(CPU)
        assert dispatch.active_tier(CPU, "cuda") == "cuda"


def test_env_unknown_tier_raises_naming_the_tiers(monkeypatch):
    _register_dummy("_t_env_bad")
    monkeypatch.setenv(ENV_VAR, "tpu")
    with pytest.raises(ValueError, match="not a kernel tier; tiers are "
                                         "cuda, torch"):
        resolve("_t_env_bad", CPU)
    # an explicit tier never reads the variable
    assert resolve("_t_env_bad", CPU, "torch")() == "torch"


def test_scope_sits_between_explicit_and_env(monkeypatch):
    _register_dummy("_t_scope")
    monkeypatch.setenv(ENV_VAR, "cuda")
    with tier_scope("torch"):
        assert resolve("_t_scope", CPU)() == "torch"
        with tier_scope(None):                  # None keeps the outer tier
            assert resolve("_t_scope", CPU)() == "torch"
    with pytest.raises(ValueError, match="CUDA tensor"):
        resolve("_t_scope", CPU)
    with pytest.raises(ValueError, match="unknown kernel tier"):
        with tier_scope("pallas"):
            pass


def test_cuda_tier_refuses_a_cpu_tensor():
    _register_dummy("_t_cpu")
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        resolve("_t_cpu", CPU, "cuda")


def test_real_ops_honor_an_explicit_tier():
    from repro_torch.kernels.quantize_act import quantize_act, quantize_act_ref

    x = torch.linspace(-3, 3, 24).reshape(3, 8)
    q, s = quantize_act(x, backend="torch")
    qr, sr = quantize_act_ref(x, 8)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    with pytest.raises(ValueError, match="CUDA tensor"):
        quantize_act(x, backend="cuda")


# ----------------------------------------------------------------- errors

def test_unknown_op_raises_with_registered_list():
    with pytest.raises(KeyError, match="unknown kernel op.*qmatmul_w8a8"):
        resolve("_t_nonexistent_op", CPU)


def test_unknown_backend_tier_rejected_at_registration():
    with pytest.raises(ValueError, match="unknown tier"):
        register_impl("_t_bad_tier", "pallas")


def test_missing_tier_raises_naming_available():
    _register_dummy("_t_partial", tiers=("torch",))
    with pytest.raises(ValueError, match="no 'cuda' implementation.*torch"):
        resolve("_t_partial", CPU, "cuda")
    with pytest.raises(ValueError, match="no 'tpu' implementation; "
                                         "registered tiers: torch"):
        resolve("_t_partial", CPU, "tpu")


def test_backends_lists_tiers_in_order():
    _register_dummy("_t_order", tiers=("torch", "cuda"))
    assert dispatch.backends("_t_order") == ("cuda", "torch")
    for op in dispatch.ops():
        assert dispatch.backends(op) == TIERS, op


def test_shadowing_refused():
    _register_dummy("_t_shadow", tiers=("torch",))
    with pytest.raises(ValueError, match="refusing to shadow"):
        @register_impl("_t_shadow", "torch")
        def other(*a, **kw):
            return None


# ------------------------------------------------------- pad conventions

def test_pad_convention_conflict_raises():
    _register_dummy("_t_pad", tiers=("torch",), pad="zero")
    with pytest.raises(ValueError, match="disagree on the pad convention"):
        @register_impl("_t_pad", "cuda", pad="zero-scale")
        def other(*a, **kw):
            return None


def test_unknown_pad_convention_rejected():
    with pytest.raises(ValueError, match="unknown pad convention"):
        register_impl("_t_pad2", "torch", pad="nan")


def test_pad_to_is_right_zero_padding():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    y = _pad_to(x, 4, dim=1)
    assert y.shape == (2, 4)
    assert torch.equal(y[:, :3], x) and bool((y[:, 3] == 0).all())
    assert _pad_to(x, 3, dim=1) is x          # already aligned: no copy


def test_real_ops_declare_their_conventions():
    assert dispatch.pad_convention("qmatmul_w8a8") == "zero"
    assert dispatch.pad_convention("qmatmul_w8a16") == "zero"
    assert dispatch.pad_convention("kv_attention") == "zero-scale"
    assert dispatch.pad_convention("fused_decode") == "zero-scale"


# ------------------------------------------------------------- enumeration

def test_serving_specs_enumerate_registry():
    specs = serving_kernel_specs(device="cpu")
    assert sorted(specs) == ["fused_decode", "kv_attention_decode",
                             "qmatmul_w8a16", "qmatmul_w8a8", "quantize_act"]
    for op, (fn, args, kw) in specs.items():
        assert callable(fn) and isinstance(args, tuple)
        assert all(a.device.type == "cpu" for a in args)
        fn(*args, **kw)                      # the plain versions run


def test_serving_specs_match_the_jax_shapes():
    from repro.kernels import serving_kernel_specs as jax_specs

    ours = serving_kernel_specs(device="cpu", head_dim=32, seq=24)
    theirs = jax_specs(head_dim=32, seq=24)
    assert sorted(ours) == sorted(theirs)
    for op in theirs:
        a, b = ours[op][1], theirs[op][1]
        assert [tuple(t.shape) for t in a] == [tuple(t.shape) for t in b], op


def test_serving_specs_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving_kernel_specs()


def test_register_spec_refuses_duplicates():
    @register_spec("_t_spec")
    def build(**kw):
        return (lambda: None, (), {})

    with pytest.raises(ValueError, match="already has a spec"):
        @register_spec("_t_spec")
        def build2(**kw):
            return (lambda: None, (), {})


def test_no_per_package_backend_selector_copies():
    """dispatch.py is the ONLY place the tier rule lives — no
    kernels/*/ops.py grows its own copy."""
    import pathlib

    import repro_torch.kernels as K

    root = pathlib.Path(K.__file__).parent
    for ops_py in root.glob("*/ops.py"):
        text = ops_py.read_text()
        assert "def tier_for" not in text, f"{ops_py} regrew a selector"
        assert ENV_VAR not in text, f"{ops_py} reads the tier variable"
        assert "def _pad_to" not in text, f"{ops_py} regrew _pad_to"


# ----------------------------------------------------- the zero point

@pytest.mark.parametrize("M,K,N,zp_shape", [(8, 64, 128, "row"),
                                            (5, 96, 40, "row"),
                                            (3, 32, 16, "scalar")])
@pytest.mark.parametrize("with_bias", [False, True])
def test_zero_point_bit_equal_to_jax_xla(M, K, N, zp_shape, with_bias):
    """y = s_a s_w (Σ a_q w_q − zp Σ_k w_q) + bias: the rank-1 term after
    the GEMM, in the reference's order, bit-equal at float32."""
    rng = np.random.RandomState(M * K + N)
    a_q = rng.randint(-128, 128, (M, K)).astype(np.int8)
    w_q = rng.randint(-127, 128, (K, N)).astype(np.int8)
    a_s = rng.uniform(1e-3, 1e-1, (M,)).astype(np.float32)
    w_s = rng.uniform(1e-3, 1e-1, (N,)).astype(np.float32)
    bias = rng.randn(N).astype(np.float32) if with_bias else None
    zp = (rng.randint(-20, 20, (M,)).astype(np.float32) if zp_shape == "row"
          else np.float32(7.0))
    want = jax_qmatmul_w8a8(
        jnp.asarray(a_q), jnp.asarray(w_q), jnp.asarray(a_s),
        jnp.asarray(w_s), None if bias is None else jnp.asarray(bias),
        a_zero_point=jnp.asarray(zp), backend="xla")
    got = qmatmul_w8a8(torch.from_numpy(a_q), torch.from_numpy(w_q),
                       torch.from_numpy(a_s), torch.from_numpy(w_s),
                       None if bias is None else torch.from_numpy(bias),
                       a_zero_point=torch.as_tensor(zp))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the zero point moves the result by exactly the rank-1 term's share
    sym = qmatmul_w8a8(torch.from_numpy(a_q), torch.from_numpy(w_q),
                       torch.from_numpy(a_s), torch.from_numpy(w_s),
                       None if bias is None else torch.from_numpy(bias))
    assert not torch.equal(got, sym)


def test_zero_point_refuses_quantize_out():
    a = torch.zeros((2, 8), dtype=torch.int8)
    w = torch.zeros((8, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="zero-point correction"):
        qmatmul_w8a8(a, w, torch.ones(2), torch.ones(4),
                     a_zero_point=torch.ones(2), quantize_out=True)
