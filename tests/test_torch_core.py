"""Parity of the port's numeric core (`repro_torch.core`) with `repro.core`.

The same numpy inputs, drawn from the seeded `rng` fixture, go through the
reference's JAX function and its port counterpart.  Tolerance: none — the
CRT tables, scaling exponents and plans are compared for equality.  Also
here: the port imports no JAX and nothing of `repro`.
"""
import itertools
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAST_K, FAST_M, FAST_N, phi_matrix

import repro.core.expansion as jex
import repro.core.moduli as jmod
import repro.core.plan as jplan
import repro.core.residues as jres
import repro.core.scaling as jscal
import repro.kernels.common as jcommon
import repro_torch.core.expansion as tex
import repro_torch.core.moduli as tmod
import repro_torch.core.plan as tplan
import repro_torch.core.residues as tres
import repro_torch.core.scaling as tscal
import repro_torch.kernels.common as tcommon
import repro_torch.kernels.crt_garner as tgarner
from repro.kernels.crt_garner import _prescale as j_prescale
from repro.kernels.crt_garner import _weight_table as j_weight_table
from repro_torch.interop import tensors_from_numpy

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


@pytest.mark.parametrize("n", [1, 7, 8, 14, 16, 21])
def test_crt_tables_match(n):
    jc, tc = jmod.make_crt_context(n), tmod.make_crt_context(n)
    assert tc.moduli == jc.moduli and tc.P == jc.P and tc.log2_P == jc.log2_P
    for field in ("garner_inv", "moduli_arr", "half_arr"):
        np.testing.assert_array_equal(getattr(tc, field), getattr(jc, field))
    np.testing.assert_array_equal(tgarner._weight_table(tc), j_weight_table(jc))
    assert tgarner._prescale(tc) == j_prescale(jc)
    nl = jplan.n_limbs_for_ctx(jc)
    assert tplan.n_limbs_for_ctx(tc) == nl
    np.testing.assert_array_equal(
        tcommon.limb_radix_f32(tc.moduli, nl), jcommon.limb_radix_f32(jc.moduli, nl)
    )


def test_crt_context_limit_n24():
    """N=24 moduli exist, but their product needs more than the 159 bits both
    packages accept, so both refuse the context."""
    assert tmod.default_moduli(24) == jmod.default_moduli(24)
    np.testing.assert_array_equal(
        tcommon.limb_radix_f32(tmod.default_moduli(24), 5),
        jcommon.limb_radix_f32(jmod.default_moduli(24), 5),
    )
    for make in (jmod.make_crt_context, tmod.make_crt_context):
        with pytest.raises(ValueError, match="159 bits"):
            make(24)


def _scaling_operands(rng, complex_):
    dt = np.complex128 if complex_ else np.float64
    a = phi_matrix(rng, (FAST_M, FAST_K), 0.5, dt)
    b = phi_matrix(rng, (FAST_K, FAST_N), 0.5, dt)
    a[3] = 0          # an all-zero row: exponent 0
    a[5] = 2.0**-7    # a power-of-two row
    b[:, 2] = 0       # an all-zero column
    b[:, 4] = 8.0     # a power-of-two column
    return a, b


@pytest.mark.parametrize("mode", ["fast", "accu"])
@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_scaling_exponents_bitwise(rng, mode, complex_):
    a, b = _scaling_operands(rng, complex_)
    for n in (7, 16):
        jc, tc = jmod.make_crt_context(n), tmod.make_crt_context(n)
        ta, tb = tensors_from_numpy((a, b), device="cpu")
        if complex_:
            jf = jscal.scale_fast_complex if mode == "fast" else jscal.scale_accurate_complex
            tf = tscal.scale_fast_complex if mode == "fast" else tscal.scale_accurate_complex
            want = jf(jnp.real(a), jnp.imag(a), jnp.real(b), jnp.imag(b), jc)
            got = tf(ta.real, ta.imag, tb.real, tb.imag, tc)
        else:
            jf = jscal.scale_fast_real if mode == "fast" else jscal.scale_accurate_real
            tf = tscal.scale_fast_real if mode == "fast" else tscal.scale_accurate_real
            want = jf(jnp.asarray(a), jnp.asarray(b), jc)
            got = tf(ta, tb, tc)
        for w, g in zip(want, got):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(got[0][3]) == 0 and int(got[1][2]) == 0


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64", "complex128"])
@pytest.mark.parametrize("mode", ["fast", "accu"])
def test_make_plan_defaults_match(dtype, mode):
    formulation = "karatsuba" if dtype.startswith("complex") else None
    jp = jplan.make_plan(dtype, mode=mode, method="garner", formulation=formulation)
    tp = tplan.make_plan(dtype, mode=mode, method="garner", formulation=formulation)
    for field in ("dtype", "n_moduli", "mode", "method", "formulation", "n_block", "out_dtype"):
        assert getattr(tp, field) == getattr(jp, field), field
    assert tp.n_limbs == jp.n_limbs
    assert str(tp.real_out_dtype).removeprefix("torch.") == jp.real_out_dtype.name


@pytest.mark.parametrize("n_block", [None, 16, "auto"])
def test_n_block_slices_match(n_block):
    shape = (64, 64, 20000)
    jp = jplan.make_plan("complex64", n_block=n_block, shape=shape, formulation="block_b")
    tp = tplan.make_plan("complex64", n_block=n_block, shape=shape, formulation="block_b")
    assert tp.n_block == jp.n_block
    assert tp.n_block_slices(20000) == jp.n_block_slices(20000)


@pytest.mark.parametrize("mega", [False, True], ids=["batched", "megakernel"])
def test_auto_formulation_matches(mega):
    """make_plan(formulation='auto') picks the reference's formulation for
    the same `hw` (passed on both sides: the port's default differs)."""
    from repro.core import perfmodel as jpm
    from repro_torch.core import perfmodel as tpm

    for name, mode, dtype, shape, batched, fused_k in itertools.product(
            sorted(jpm.HARDWARE), ("fast", "accu"), ("complex64", "complex128"),
            [(8, 8, 8), (96, 96, 96), (4096, 4096, 4096), (64, 70000, 32)], (False, True), (False, True)):
        kw = dict(mode=mode, formulation="auto", shape=shape, fused_karatsuba=fused_k,
                  modulus_batched=batched, megakernel=mega)
        jp = jplan.make_plan(dtype, hw=jpm.HARDWARE[name], **kw)
        tp = tplan.make_plan(dtype, hw=tpm.HARDWARE[name], **kw)
        assert tp.formulation == jp.formulation, (name, kw)
    with pytest.raises(ValueError, match="shape"):
        tplan.make_plan("complex64", formulation="auto")


def test_expansion_bitwise(rng):
    """two_prod / dd_add in f32, the op order the Garner sum relies on."""
    a = rng.standard_normal(4096).astype(np.float32)
    b = rng.integers(-127, 128, 4096).astype(np.float32)
    c = rng.standard_normal(4096).astype(np.float32) * np.float32(1e-8)
    ta, tb, tc = tensors_from_numpy((a, b, c), device="cpu")
    for want, got in zip(jex.two_prod(jnp.asarray(a), jnp.asarray(b)), tex.two_prod(ta, tb)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jex.dd_add(jnp.asarray(a), jnp.asarray(c), jnp.asarray(b), jnp.asarray(c))
    got = tex.dd_add(ta, tc, tb, tc)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sym_mod_and_limbs_match(rng):
    v = rng.integers(-(2**31), 2**31 - 1, size=5000, dtype=np.int64).astype(np.int32)
    for p in (255, 197, 163):
        np.testing.assert_array_equal(
            tres.sym_mod_int32(torch.from_numpy(v), p).numpy(),
            np.asarray(jres.sym_mod_int32(jnp.asarray(v), p)),
        )
    for bits in (10.0, 23.0, 71.5, 99.0):
        assert tres.num_limbs_for_bits(bits) == jres.num_limbs_for_bits(bits)


def test_interop_default_device_is_the_card(monkeypatch):
    """`tensors_from_numpy` and `prepared_from_numpy` place their tensors by
    `resolve_device`, whose default is the card: without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None places the tensors there")
    import repro_torch.interop as interop

    fields = {"side": "right", "n_moduli": 2, "n_limbs": 1, "dtype": "float32", "e_scale": None,
              "e_bound": None, "raw": None, "residues": (np.zeros((2, 3, 4), np.int8),), "bound": ()}
    cases = ((interop.tensors_from_numpy, np.zeros(3)), (interop.prepared_from_numpy, fields))
    for convert, arg in cases:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert(arg)
    asked = []
    monkeypatch.setattr(interop, "resolve_device", lambda device: asked.append(device) or torch.device("cpu"))
    for convert, arg in cases:
        asked.clear()
        convert(arg)
        assert asked[0] is None


def test_port_imports_no_jax():
    """In a fresh interpreter: importing the port pulls in no JAX (the test
    process itself has JAX loaded by conftest, hence the subprocess)."""
    code = (
        "import repro_torch, repro_torch.kernels.ops, repro_torch.interop, repro_torch.optim, "
        "repro_torch.data, repro_torch.train, repro_torch.tree, repro_torch.distributed, repro_torch.launch.train, "
        "repro_torch.distributed.sharded_gemm, repro_torch.distributed.sharding, repro_torch.launch.mesh, "
        "repro_torch.launch.serve, sys; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert 'repro' not in sys.modules, 'repro imported'"
    )
    subprocess.run([sys.executable, "-c", code], check=True, env={**os.environ, "PYTHONPATH": str(SRC)})


def test_port_source_names_no_jax_or_reference():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_torch)|from repro[ .]|import repro\.)", re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert len(files) >= 15
    for path in files:
        assert not pattern.search(path.read_text()), path
