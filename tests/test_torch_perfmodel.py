"""Parity of the port's performance model and accuracy bounds
(`repro_torch.core.perfmodel`, `repro_torch.core.accuracy`) with the
reference's, and of the automatic choices they drive.

Both packages compute the model and the bounds in plain Python floats, so
every term, selection, launch count and bound is compared for equality
(tolerance 0) over a grid of shapes x moduli x mode x precision x every
`HARDWARE` preset.  `probe_operands` and `rel_error` reduce over the
operands — numpy in the reference, float64 torch in the port — so their
results are held to a relative tolerance of 1e-12 (summation order).

The one deliberate difference is `default_hw()` with no calibration: the
reference prices for TPU v5e, the port for GH200.  The parity cases of the
automatic choices therefore pass `hw` explicitly or activate the same
measurement dict on both sides.
"""
import dataclasses
import itertools

import numpy as np
import pytest

from conftest import phi_matrix

from repro.core import accuracy as jacc
from repro.core import perfmodel as jpm
from repro.core.policy import GemmPolicy as JPolicy
from repro.tune import cache as jcache
from repro_torch.core import accuracy as tacc
from repro_torch.core import perfmodel as tpm
from repro_torch.core.policy import GemmPolicy as TPolicy
from repro_torch.tune import cache as tcache

PRESETS = sorted(jpm.HARDWARE)
SHAPES = [(1, 1, 1), (64, 32, 16), (257, 1000, 129), (4096, 4096, 4096), (8192, 512, 16384)]
MODULI = [1, 7, 8, 14, 16, 20]

#: measurement dicts that make different 'auto' choices: the GH200 preset's
#: numbers, a launch-dominated machine, and an fp8-rich one
MEASUREMENTS = {
    "gh200-like": dict(mem_bw=4e12, int8_ops=1.979e15, fp8_ops=1.979e15, native_c64=67e12,
                       native_c128=34e12, gemm_launch_s=5e-6),
    "launch-bound": dict(mem_bw=1e9, int8_ops=5e12, gemm_launch_s=5e-3),
    "fp8-rich": dict(mem_bw=3e12, int8_ops=4e14, fp8_ops=4e16, gemm_launch_s=2e-5),
}


def _hw(name):
    return jpm.HARDWARE[name], tpm.HARDWARE[name]


def test_presets_equal():
    assert sorted(tpm.HARDWARE) == PRESETS
    for name in PRESETS:
        j, t = _hw(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (tpm.GEMM_LAUNCH_S, tpm.COLLECTIVE_LAUNCH_S) == (jpm.GEMM_LAUNCH_S, jpm.COLLECTIVE_LAUNCH_S)
    assert tpm.ENGINE_OP_FACTOR == jpm.ENGINE_OP_FACTOR and tpm.ENGINES == jpm.ENGINES


def test_default_hw_is_gh200_not_v5e():
    """The port's one deliberate difference: no calibration prices a Hopper part."""
    assert tcache.current_calibration() is None
    assert tpm.default_hw() is tpm.GH200
    assert jpm.default_hw() is jpm.TPU_V5E


@pytest.mark.parametrize("meas", [
    {"mem_bw": 1e12, "int8_ops": 2e14},
    {"mem_bw": 1e12, "int8_ops": 2e14, "fp8_ops": 0.0, "gemm_launch_s": -1.0, "ici_bw": None},
    dict(MEASUREMENTS["gh200-like"], ici_bw=1e11, collective_launch_s=3e-5),
], ids=["required-only", "unmeasured", "full"])
def test_hw_from_calibration_equal(meas):
    j = jpm.HW.from_calibration(meas, name="x")
    t = tpm.HW.from_calibration(meas, name="x")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("preset", PRESETS)
def test_time_terms_equal(preset):
    jhw, thw = _hw(preset)
    for engine in ("int8", "fp8"):
        assert tpm.engine_rate(thw, engine) == jpm.engine_rate(jhw, engine)
    for (m, k, n), N, mode, engine in itertools.product(SHAPES, MODULI, ("fast", "accu"), ("int8", "fp8")):
        for prec in ("c", "z"):
            for c in (None, 3.0):
                args = (m, n, k, N)
                assert tpm.complex_time_s(*args, thw, mode, prec, c, engine) == \
                    jpm.complex_time_s(*args, jhw, mode, prec, c, engine)
                assert tpm.complex_tflops(*args, thw, mode, prec, c, engine) == \
                    jpm.complex_tflops(*args, jhw, mode, prec, c, engine)
            assert tpm.engine_time_s(engine, m, n, k, N, thw, mode, prec) == \
                jpm.engine_time_s(engine, m, n, k, N, jhw, mode, prec)
        for prec in ("s", "d"):
            assert tpm.real_time_s(m, n, k, N, thw, mode, prec, None, engine) == \
                jpm.real_time_s(m, n, k, N, jhw, mode, prec, None, engine)
            assert tpm.real_tflops(m, n, k, N, thw, mode, prec, None, engine) == \
                jpm.real_tflops(m, n, k, N, jhw, mode, prec, None, engine)
            assert tpm.engine_time_s(engine, m, n, k, N, thw, mode, prec) == \
                jpm.engine_time_s(engine, m, n, k, N, jhw, mode, prec)
    assert tpm.ozaki1_complex_time_s(512, 256, 1024, 5, thw) == jpm.ozaki1_complex_time_s(512, 256, 1024, 5, jhw)


@pytest.mark.parametrize("preset", PRESETS)
def test_formulation_terms_and_selection_equal(preset):
    jhw, thw = _hw(preset)
    flags = list(itertools.product((1, 3), (False, True), (False, True)))
    for (m, k, n), N, mode, prec, engine in itertools.product(
            SHAPES, MODULI, ("fast", "accu"), ("c", "z"), ("int8", "fp8")):
        for launches, batched, mega in flags:
            kw = dict(karatsuba_launches=launches, modulus_batched=batched, megakernel=mega,
                      comm_s=1e-4 if batched else 0.0, engine=engine)
            for form in ("karatsuba", "block_a", "block_b"):
                assert tpm.formulation_time_s(form, m, n, k, N, thw, mode, prec, **kw) == \
                    jpm.formulation_time_s(form, m, n, k, N, jhw, mode, prec, **kw)
            assert tpm.select_formulation(m, n, k, N, thw, mode, prec, **kw) == \
                jpm.select_formulation(m, n, k, N, jhw, mode, prec, **kw)


@pytest.mark.parametrize("preset", PRESETS)
def test_engine_and_mode_selection_equal(preset):
    jhw, thw = _hw(preset)
    for (m, k, n), N, prec in itertools.product(SHAPES, MODULI, ("s", "d", "c", "z")):
        for mode in ("fast", "accu"):
            assert tpm.select_engine(m, n, k, N, thw, mode, prec) == \
                jpm.select_engine(m, n, k, N, jhw, mode, prec)
        cands = [("fast", N), ("accu", max(1, N - 2)), ("fast", N + 1)]
        for engine in ("int8", "fp8"):
            assert tpm.select_mode(m, n, k, cands, thw, prec, engine) == \
                jpm.select_mode(m, n, k, cands, jhw, prec, engine)
    with pytest.raises(ValueError):
        tpm.select_mode(8, 8, 8, [], thw)


@pytest.mark.parametrize("preset", PRESETS)
def test_sharded_comm_term_equal(preset):
    jhw, thw = _hw(preset)
    for (m, k, n), N, shards, cplx, blocks in itertools.product(
            SHAPES, MODULI, (1, 2, 4), (False, True), (1, 3)):
        assert tpm.sharded_comm_time_s(m, n, N, shards, thw, cplx, blocks) == \
            jpm.sharded_comm_time_s(m, n, N, shards, jhw, cplx, blocks)


def test_crt_partial_parts_equal():
    for n in range(1, 21):
        assert tpm.crt_partial_parts(n) == jpm.crt_partial_parts(n), n


def test_kernel_launch_count_equal():
    for N, form, batched, fused_k, chunks, blocks, prepared, fused in itertools.product(
            MODULI, ("real", "karatsuba", "block_a", "block_b"), (False, True), (False, True),
            (1, 3), (1, 2), (False, True), (False, True)):
        kw = dict(modulus_batched=batched, fused_karatsuba=fused_k, n_chunks=chunks,
                  n_blocks=blocks, prepared=prepared, fused=fused)
        assert tpm.kernel_launch_count(N, form, **kw) == jpm.kernel_launch_count(N, form, **kw)
    # the counts the port's chip smoke test holds its launch counters to
    assert tpm.kernel_launch_count(14, "karatsuba") == 4
    assert tpm.kernel_launch_count(8, "real", prepared=True) == 3
    assert tpm.kernel_launch_count(14, "karatsuba", fused=True) == 1


def test_select_block_and_padded_dim_equal():
    for dim, block, align in itertools.product(
            (1, 7, 128, 129, 257, 300, 1000, 4097), (32, 64, 100, 128, 256, 512), (None, 8, 32, 128)):
        assert tpm.select_block(dim, block, align) == jpm.select_block(dim, block, align)
        assert tpm.padded_dim(dim, block, align) == jpm.padded_dim(dim, block, align)
    for bad in ((0, 8, None), (8, 0, None)):
        with pytest.raises(ValueError):
            tpm.select_block(*bad)


# ----------------------------------------------------------- accuracy


DTYPES = ("float32", "float64", "complex64", "complex128")


@pytest.mark.parametrize("dtype", DTYPES)
def test_rel_bound_equal(dtype):
    stats = [None, jacc.GemmStats(k=300), jacc.GemmStats(k=300, log2_norm_a=3.5, log2_norm_b=9.0,
                                                          log2_cbar=14.25)]
    forms = (None, "auto", "karatsuba", "block_a", "block_b") if dtype.startswith("complex") else (None,)
    for mode, N, k, form, st, out in itertools.product(
            ("fast", "accu"), range(1, 21), (1, 300, 4096, 1 << 20), forms, stats, (None, "float64")):
        tst = None if st is None else tacc.GemmStats(**dataclasses.asdict(st))
        try:
            want = jacc.rel_bound(dtype, mode, N, k, formulation=form, stats=st, out_dtype=out)
        except ValueError:
            with pytest.raises(ValueError):
                tacc.rel_bound(dtype, mode, N, k, formulation=form, stats=tst, out_dtype=out)
            continue
        assert tacc.rel_bound(dtype, mode, N, k, formulation=form, stats=tst, out_dtype=out) == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_min_moduli_for_equal(dtype):
    for rtol, mode, k in itertools.product(
            (1e-2, 1e-4, 1e-6, 1e-9, 1e-12, 1e-15, 1e-17), ("fast", "accu"), (16, 4096, 1 << 20)):
        try:
            want = jacc.min_moduli_for(rtol, dtype, k=k, mode=mode)
        except ValueError:
            with pytest.raises(ValueError, match="unreachable"):
                tacc.min_moduli_for(rtol, dtype, k=k, mode=mode)
            continue
        assert tacc.min_moduli_for(rtol, dtype, k=k, mode=mode) == want
    with pytest.raises(ValueError):
        tacc.min_moduli_for(0.0, dtype, k=4)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128], ids=["real", "complex"])
def test_probe_operands_and_rel_error_close(rng, dtype):
    """Within rtol 1e-12: the reductions run in another order (numpy vs
    torch float64).  The 7-bit bars are integers, so cbar is equal."""
    import torch

    a = phi_matrix(rng, (37, 91), 2.0, dtype)
    b = phi_matrix(rng, (91, 23), 2.0, dtype)
    want = jacc.probe_operands(a, b)
    for ta, tb in ((a, b), (torch.from_numpy(a), torch.from_numpy(b))):
        got = tacc.probe_operands(ta, tb)
        assert got.k == want.k
        for field in ("log2_norm_a", "log2_norm_b"):
            np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=1e-12)
        assert got.log2_cbar == want.log2_cbar
    c_ref = a @ b
    c_emul = (c_ref + 1e-9 * phi_matrix(rng, c_ref.shape, 0.5, dtype)).astype(dtype)
    np.testing.assert_allclose(tacc.rel_error(c_emul, c_ref, a, b), jacc.rel_error(c_emul, c_ref, a, b),
                               rtol=1e-12)
    assert tacc.rel_error(c_ref, c_ref, a, b) == 0.0


# ---------------------------------------- automatic choices, same measurement


def _calibrations(meas):
    """The same measured HW active on both sides (each keyed to its live process)."""
    jcal = jcache.Calibration(hw=jpm.HW.from_calibration(meas, name="m"), **jcache.live_key())
    tcal = tcache.Calibration(hw=tpm.HW.from_calibration(meas, name="m"), **tcache.live_key("cpu"))
    return jcal, tcal


@pytest.mark.parametrize("execution", ["kernel", "fused", "fp8"])
@pytest.mark.parametrize("meas", list(MEASUREMENTS))
def test_resolve_adaptive_equal(execution, meas):
    jcal, tcal = _calibrations(MEASUREMENTS[meas])
    for backend, mode, n_moduli, rtol, (m, k, n) in itertools.product(
            ("ozaki2_f32", "ozaki2_f64", "ozaki2_c64", "ozaki2_c128"), ("auto", "fast", "accu"),
            (None, 9), (1e-3, 1e-6, 1e-12), [(64, 48, 32), (4096, 4096, 4096), (100, 1 << 18, 100)]):
        fields = dict(backend=backend, mode=mode, n_moduli=n_moduli, rtol=rtol, execution=execution)
        with jcache.use_calibration(jcal):
            try:
                want = JPolicy(**fields).resolve_adaptive(m, k, n)
            except ValueError:
                want = None
        with tcache.use_calibration(tcal):
            if want is None:
                with pytest.raises(ValueError, match="meets rtol"):
                    TPolicy(**fields).resolve_adaptive(m, k, n)
                continue
            got = TPolicy(**fields).resolve_adaptive(m, k, n)
        assert (got.mode, got.n_moduli, got.rtol) == (want.mode, want.n_moduli, want.rtol), fields


PLAN_FIELDS = ("dtype", "n_moduli", "mode", "method", "formulation", "n_block", "out_dtype", "rtol")


@pytest.mark.parametrize("execution", ["kernel", "fused", "fp8"])
@pytest.mark.parametrize("meas", list(MEASUREMENTS))
def test_auto_plans_equal(execution, meas):
    """formulation='auto' / n_block='auto' (and rtol) plans, field for field."""
    jcal, tcal = _calibrations(MEASUREMENTS[meas])
    for backend, mode, rtol, (m, k, n) in itertools.product(
            ("ozaki2_c64", "ozaki2_c128", "ozaki2_f64"), ("fast", "accu"), (None, 1e-6),
            [(16, 16, 16), (96, 96, 96), (4096, 4096, 4096), (512, 2048, 20000)]):
        fields = dict(backend=backend, mode="auto" if rtol else mode, rtol=rtol, execution=execution,
                      formulation="auto", n_block="auto")
        with jcache.use_calibration(jcal):
            want = JPolicy(**fields).plan_for(m, k, n)
        with tcache.use_calibration(tcal):
            got = TPolicy(**fields).plan_for(m, k, n)
        for f in PLAN_FIELDS:
            assert getattr(got, f) == getattr(want, f), (fields, (m, k, n), f)


def test_auto_choices_follow_the_measurement():
    """The parity grid above is not vacuous: the measurement changes what
    'auto' resolves to (mode / moduli) in both packages alike."""
    picks = set()
    for meas in MEASUREMENTS:
        _, tcal = _calibrations(MEASUREMENTS[meas])
        with tcache.use_calibration(tcal):
            pol = TPolicy(backend="ozaki2_c128", mode="auto", rtol=1e-9, execution="fp8")
            r = pol.resolve_adaptive(4096, 4096, 4096)
            picks.add((r.mode, r.n_moduli, tpm.select_engine(4096, 4096, 4096, 14)))
    assert len(picks) > 1
