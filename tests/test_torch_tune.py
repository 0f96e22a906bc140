"""The port's tuning package (`repro_torch.tune`): the calibration cache,
its scoping, the tile resolution of the kernels, and the calibration entry
point on the CPU.

Ported from the cache and scoping cases of `tests/test_tune.py`; the
contract is the reference's:

* the cache round-trips exactly and degrades, never breaks: a stale,
  corrupt or missing file warns and falls back to the presets (GH200 here)
  and the kernels' default tiles; a cache written by the reference package
  is stale here;
* with a calibration active, the measured `HW` drives the 'auto' decisions
  and the kernels launch the tuned tiles, which never change the bits;
* the port's tiles are the CUDA kernels' compiled ones
  (`kernels.common.COMPILED_TILES`): an unknown tile, tuned or explicit,
  raises.

The tile launches themselves run only on the card (`chip_smoke.py` holds
every compiled tile bitwise to its plain version); here the wrappers take
their plain versions, which ignore the tile.
"""
import dataclasses
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import phi_matrix

import repro_torch
from repro_torch import linalg as tl
from repro_torch.core import perfmodel
from repro_torch.core.perfmodel import GH200, HW
from repro_torch.core.policy import GemmPolicy
from repro_torch.kernels import launch_copy as lc
from repro_torch.kernels.common import COMPILED_TILES, TILE_SOURCES, resolve_blocks
from repro_torch.tune.cache import (
    Calibration,
    block_key,
    calibration_hash,
    current_calibration,
    default_cache_path,
    live_key,
    load_calibration,
    save_calibration,
    set_calibration,
    shape_bucket,
    use_calibration,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def make_cal(blocks=None, **hw_over) -> Calibration:
    """A live-keyed (CPU) calibration with a distinctive measured HW."""
    hw = dataclasses.replace(
        HW("calibrated/test", mem_bw=1e10, int8_ops=5e12, native_c64=0.0,
           native_c128=0.0, ici_bw=1e9, fp8_ops=0.0, gemm_launch_s=1e-4,
           collective_launch_s=3e-4),
        **hw_over,
    )
    return Calibration(**live_key("cpu"), hw=hw).with_blocks(blocks or {})


# --------------------------------------------------------------- the cache


def test_cache_roundtrip(tmp_path):
    cal = make_cal({
        block_key("kernel", "real", 256, 256, 512): (64, 128, 64),
        block_key("fused", "complex", 2048, 2048, 2048): (64, 32, 64),
    })
    path = save_calibration(cal, str(tmp_path / "cal.json"))
    loaded = load_calibration(path)
    assert loaded == cal
    assert hash(loaded) == hash(cal)
    assert calibration_hash(loaded) == calibration_hash(cal)
    assert calibration_hash(None) is None
    assert loaded.block_for("kernel/real/m256n256k512") == (64, 128, 64)
    assert loaded.block_for("kernel/real/m128n128k128") is None
    key = json.load(open(path))["key"]
    assert set(key) == {"device_kind", "device_count", "torch_version", "cuda_version"}
    assert key["torch_version"] == torch.__version__


@pytest.mark.parametrize("field", ["device_count", "torch_version", "cuda_version"])
def test_cache_stale_key_warns_and_falls_back(tmp_path, field):
    path = str(tmp_path / "cal.json")
    save_calibration(make_cal(), path)
    obj = json.load(open(path))
    obj["key"][field] = 7 if field == "device_count" else "other"
    json.dump(obj, open(path, "w"))
    with pytest.warns(RuntimeWarning, match="stale"):
        assert load_calibration(path) is None
    # the staleness check is opt-out for offline inspection
    assert load_calibration(path, check_staleness=False) is not None


def test_reference_written_cache_is_stale(tmp_path):
    """A cache of `python -m repro.tune` keys on a jax version and has no
    torch version: stale here, with a warning, never used."""
    from repro.core.perfmodel import HW as JHW
    from repro.tune.cache import Calibration as JCalibration
    from repro.tune.cache import live_key as j_live_key
    from repro.tune.cache import save_calibration as j_save

    jcal = JCalibration(hw=JHW.from_calibration({"mem_bw": 1e10, "int8_ops": 1e12}), **j_live_key())
    jcal = jcal.with_blocks({"kernel/real/m128n128k128": (256, 256, 512)})
    path = j_save(jcal, str(tmp_path / "repro.json"))
    with pytest.warns(RuntimeWarning, match="stale"):
        assert load_calibration(path) is None
    with pytest.warns(RuntimeWarning, match="stale"):
        with use_calibration(path):
            assert current_calibration() is None


@pytest.mark.parametrize("payload", [
    "definitely not json {",
    json.dumps({"schema": 1}),                        # missing key/hw
    json.dumps({"schema": 99, "key": {}, "hw": {}}),  # wrong schema
])
def test_cache_corruption_warns_and_falls_back(tmp_path, payload):
    path = tmp_path / "cal.json"
    path.write_text(payload)
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert load_calibration(str(path)) is None


def test_cache_malformed_blocks_rejected(tmp_path):
    path = str(tmp_path / "cal.json")
    save_calibration(make_cal(), path)
    obj = json.load(open(path))
    obj["blocks"] = {"kernel/real/m128n128k128": [256, -1, 0]}
    json.dump(obj, open(path, "w"))
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert load_calibration(path) is None


def test_cache_missing_file_warns_none(tmp_path):
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert load_calibration(str(tmp_path / "nope.json")) is None


def test_default_cache_path_respects_env_and_differs_from_reference(tmp_path, monkeypatch):
    from repro.tune.cache import default_cache_path as j_default

    monkeypatch.setenv("REPRO_TORCH_CALIBRATION_DIR", str(tmp_path))
    p = default_cache_path()
    assert p.startswith(str(tmp_path)) and p.endswith(".json")
    monkeypatch.delenv("REPRO_TORCH_CALIBRATION_DIR")
    monkeypatch.delenv("REPRO_CALIBRATION_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert pathlib.Path(default_cache_path()).parent != pathlib.Path(j_default()).parent


def test_shape_bucketing_matches_reference():
    from repro.tune.cache import block_key as j_block_key
    from repro.tune.cache import shape_bucket as j_bucket

    assert shape_bucket(1, 1, 1) == "m128n128k128"
    assert shape_bucket(129, 256, 300) == "m256n256k512"
    assert shape_bucket(10**6, 1, 1).startswith("m16384")
    for m, n, k in [(1, 1, 1), (129, 256, 300), (4096, 4096, 4096), (10**6, 3, 70000)]:
        assert shape_bucket(m, n, k) == j_bucket(m, n, k)
        for family in ("kernel", "fused", "fp8"):
            for dclass in ("real", "complex"):
                assert block_key(family, dclass, m, n, k) == j_block_key(family, dclass, m, n, k)
    with pytest.raises(ValueError):
        block_key("nope", "real", 1, 1, 1)
    with pytest.raises(ValueError):
        block_key("kernel", "int8", 1, 1, 1)


# ------------------------------------------------------------------ scoping


def test_scoping_thread_local_beats_global():
    a, b = make_cal(), make_cal(mem_bw=2e10)
    assert current_calibration() is None
    try:
        set_calibration(a)
        assert current_calibration() == a
        with use_calibration(b):
            assert current_calibration() == b  # innermost wins
        assert current_calibration() == a
    finally:
        set_calibration(None)
    assert current_calibration() is None
    with pytest.raises(TypeError):
        set_calibration("not a calibration")


def test_use_calibration_from_unfit_path_is_noop(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{")
    with pytest.warns(RuntimeWarning):
        with use_calibration(str(bad)):
            assert current_calibration() is None  # degraded, not broken


# ------------------------------------- measured HW drives 'auto' decisions


def test_default_hw_is_gh200_without_calibration():
    assert perfmodel.default_hw() is GH200


def test_default_hw_follows_active_calibration():
    cal = make_cal()
    with use_calibration(cal):
        assert perfmodel.default_hw() == cal.hw
    assert perfmodel.default_hw() is GH200


def test_calibrated_hw_flips_engine_auto_selection():
    """An fp8-rich measured HW flips select_engine: 'auto' decisions price
    against the measurement, not the preset."""
    shape = (4096, 4096, 4096, 14)
    assert perfmodel.select_engine(*shape) == "int8"  # GH200: e4m3 at the int8 rate
    with use_calibration(make_cal(fp8_ops=100 * 5e12)):
        assert perfmodel.select_engine(*shape) == "fp8"
    assert perfmodel.select_engine(*shape) == "int8"


def test_pinned_policy_calibration_is_deterministic(tmp_path):
    """GemmPolicy(calibration=path): the same plan on every call, equal to
    the plan under an ambient use_calibration of the same cache, and the pin
    beats another ambient calibration."""
    cal = make_cal(mem_bw=1e9, gemm_launch_s=5e-3)
    path = save_calibration(cal, str(tmp_path / "cal.json"))
    base = dict(backend="ozaki2_c64", mode="auto", rtol=1e-5, formulation="auto",
                n_block="auto", execution="kernel")
    pinned = GemmPolicy(calibration=path, **base)
    plan1 = pinned.plan_for(96, 96, 96)
    assert plan1 == pinned.plan_for(96, 96, 96)
    assert pinned.resolved_calibration() == cal
    with use_calibration(cal):
        assert GemmPolicy(**base).plan_for(96, 96, 96) == plan1
    other = make_cal(mem_bw=9e14, int8_ops=9e15, gemm_launch_s=1e-9)
    with use_calibration(other):
        assert pinned.plan_for(96, 96, 96) == plan1
        assert GemmPolicy(**base).resolved_calibration() == other


def test_policy_pinned_unfit_cache_degrades(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("broken")
    with pytest.warns(RuntimeWarning):
        pol = GemmPolicy(backend="ozaki2_c64", n_moduli=5, formulation="auto",
                         calibration=str(bad), execution="fused")
        plan = pol.plan_for(64, 64, 64)
    ref = GemmPolicy(backend="ozaki2_c64", n_moduli=5, formulation="auto",
                     execution="fused").plan_for(64, 64, 64)
    assert plan == ref  # unfit pin == no pin == presets


# ---------------------------------------------- tiles: resolution + parity


def test_compiled_tiles_are_the_sources_instantiations():
    """COMPILED_TILES lists exactly the tiles each CUDA source instantiates
    (its REPRO_TILE lines), default first."""
    for slot, tiles in COMPILED_TILES.items():
        src = (CSRC / f"{TILE_SOURCES[slot]}.cu").read_text()
        found = [tuple(int(x) for x in t[:3])
                 for t in re.findall(r"^\s*REPRO_TILE\((\d+), (\d+), (\d+), (\d+)\)", src, re.M)]
        assert tuple(found) == tiles, slot
        assert len(tiles) >= (3 if slot[0] == "kernel" else 2)


def test_resolve_blocks_defaults_without_calibration():
    for (family, dclass), tiles in COMPILED_TILES.items():
        assert resolve_blocks(family, dclass, 300, 300, 300) == tiles[0]
    assert resolve_blocks("kernel", "real", 300, 300, 300) == (128, 128, 64)
    assert resolve_blocks("fused", "complex", 300, 300, 300) == (64, 64, 64)


def test_resolve_blocks_reads_tuned_and_respects_overrides():
    key = block_key("kernel", "real", 300, 300, 300)
    with use_calibration(make_cal({key: (64, 128, 64)})):
        assert resolve_blocks("kernel", "real", 300, 300, 300) == (64, 128, 64)
        # explicit per-axis values beat the tuned winner
        assert resolve_blocks("kernel", "real", 300, 300, 300, bm=128) == (128, 128, 64)
        assert resolve_blocks("kernel", "real", 300, 300, 300, bm=128, bn=64, bk=64) == (128, 64, 64)
        # a slot the cache does not cover takes the kernel's default
        assert resolve_blocks("fused", "real", 300, 300, 300) == (64, 64, 64)
        assert resolve_blocks("kernel", "real", 5000, 300, 300) == (128, 128, 64)
    assert resolve_blocks("kernel", "real", 300, 300, 300) == (128, 128, 64)


def test_resolve_blocks_unknown_tile_raises():
    with pytest.raises(ValueError, match="not compiled"):
        resolve_blocks("kernel", "real", 300, 300, 300, bm=1, bn=2, bk=3)
    with pytest.raises(ValueError, match="not compiled"):
        resolve_blocks("fused", "complex", 300, 300, 300, bk=128)
    with pytest.raises(ValueError):
        resolve_blocks("nope", "real", 300, 300, 300, bm=128, bn=128, bk=64)
    # a tuned entry naming a tile the kernel does not compile is an error
    bad = make_cal({block_key("fp8", "real", 300, 300, 300): (256, 256, 512)})
    with use_calibration(bad):
        with pytest.raises(ValueError, match="not compiled"):
            resolve_blocks("fp8", "real", 300, 300, 300)


def _wrapper_cases(rng):
    from repro_torch.core.moduli import make_crt_context
    from repro_torch.core.plan import n_limbs_for_ctx
    from repro_torch.kernels import fp8_mod_gemm as f8
    from repro_torch.kernels import int8_mod_gemm as ig
    from repro_torch.kernels import karatsuba_fused as kf

    ctx = make_crt_context(5)
    m, k, n = 40, 72, 56
    p = [torch.from_numpy(rng.integers(-60, 61, s, dtype=np.int8)) for s in
         [(5, m, k), (5, m, k), (5, k, n), (5, k, n)]]
    f = [torch.from_numpy(rng.integers(-500, 501, s).astype(np.float32)) for s in
         [(m, k), (m, k), (k, n), (k, n)]]
    e_mu, e_nu = torch.zeros(m, dtype=torch.int32), torch.zeros(n, dtype=torch.int32)
    nl = n_limbs_for_ctx(ctx)
    return {
        ("kernel", "real"): lambda t: ig.int8_mod_gemm_batched(p[0], p[2], moduli=ctx.moduli, tile=t),
        ("kernel", "complex"): lambda t: kf.karatsuba_mod_gemm_batched(*p, moduli=ctx.moduli, tile=t),
        ("fused", "real"): lambda t: ig.fused_mod_gemm(f[0], f[2], e_mu, e_nu, ctx, n_limbs=nl, tile=t),
        ("fused", "complex"): lambda t: kf.fused_karatsuba_mod_gemm(
            *f, e_mu, e_nu, ctx, n_limbs=nl, tile=t),
        ("fp8", "real"): lambda t: f8.fp8_mod_gemm_batched(p[0], p[2], moduli=ctx.moduli, tile=t),
        ("fp8", "complex"): lambda t: f8.fp8_karatsuba_mod_gemm_batched(*p, moduli=ctx.moduli, tile=t),
    }


@pytest.mark.parametrize("slot", list(COMPILED_TILES), ids=lambda s: "-".join(s))
def test_wrappers_take_every_compiled_tile_and_reject_others(rng, slot):
    """Every compiled tile is accepted (and on the CPU gives the plain
    version's bits, the default's); an uncompiled one raises even on the CPU."""
    call = _wrapper_cases(rng)[slot]

    def flat(y):
        return torch.cat([t.flatten().double() for t in y]) if isinstance(y, tuple) else y.double()

    want = flat(call(None))
    for tile in COMPILED_TILES[slot]:
        assert torch.equal(flat(call(tile)), want)
    with pytest.raises(ValueError, match="not compiled"):
        call((256, 256, 512))


def test_tuned_tiles_bitwise_through_the_policy_route(rng):
    """linalg on the kernel execution under a tuned calibration (every slot
    of the shape tuned to a non-default tile) == no calibration, bitwise."""
    m, k, n = 40, 72, 56
    tuned = {block_key(f, d, m, n, k): tiles[-1] for (f, d), tiles in COMPILED_TILES.items()}
    for routine, dtype in (("sgemm", np.float32), ("zgemm", np.complex128)):
        a = phi_matrix(rng, (m, k), 0.5, dtype)
        b = phi_matrix(rng, (k, n), 0.5, dtype)
        for execution in ("kernel", "fused", "fp8"):
            pol = GemmPolicy(n_moduli=5, execution=execution)
            want = getattr(tl, routine)(a, b, policy=pol, device="cpu")
            with use_calibration(make_cal(tuned)):
                got = getattr(tl, routine)(a, b, policy=pol, device="cpu")
            assert torch.equal(got, want)


def test_backends_resolve_the_tuned_tile_per_launch(rng, monkeypatch):
    """The kernel backend asks `resolve_blocks` for each launch's tile and
    passes the tuned one to the wrapper."""
    from repro_torch.kernels import ops

    seen = []
    real = ops.int8_mod_gemm_batched

    def spy(*args, tile=None, **kw):
        seen.append(tile)
        return real(*args, tile=tile, **kw)

    monkeypatch.setattr(ops, "int8_mod_gemm_batched", spy)
    m, k, n = 40, 72, 56
    a = phi_matrix(rng, (m, k), 0.5, np.float32)
    b = phi_matrix(rng, (k, n), 0.5, np.float32)
    pol = GemmPolicy(n_moduli=5, execution="kernel")
    tl.sgemm(a, b, policy=pol, device="cpu")
    path_cal = make_cal({block_key("kernel", "real", m, n, k): (64, 128, 64)})
    with use_calibration(path_cal):
        tl.sgemm(a, b, policy=pol, device="cpu")
    assert seen == [(128, 128, 64), (64, 128, 64)]


# -------------------------------------------- the copy kernel, calibration


def test_launch_copy_plain_is_a_copy(rng):
    x = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32))
    before = lc.launch_copy.launches
    y = lc.launch_copy(x)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert lc.launch_copy.launches == before  # the plain version launches nothing
    with pytest.raises(TypeError):
        lc.launch_copy(x.double())


def _check_structure(cal):
    assert cal.device_kind == "cpu" and cal.device_count == 1
    assert cal.torch_version == torch.__version__
    hw = cal.hw
    assert hw.mem_bw > 0 and hw.int8_ops > 0 and hw.gemm_launch_s > 0
    assert hw.native_c64 > 0 and hw.native_c128 > 0
    assert hw.fp8_ops == 0.0  # no e4m3 matmul on the CPU: by the device type
    # one block winner per (family, dclass, smoke shape), each a compiled tile
    assert len(cal.blocks) == 3 * 2 * 2
    for key, tile in cal.blocks:
        family, dclass, _ = key.split("/")
        assert tile in COMPILED_TILES[family, dclass]


def test_calibrate_smoke_on_cpu_is_structurally_valid(tmp_path):
    from repro_torch.tune.calibrate import calibrate

    cal = calibrate(smoke=True, device="cpu")
    _check_structure(cal)
    path = save_calibration(cal, str(tmp_path / "cal.json"))
    assert load_calibration(path) == cal


def test_tune_cli_smoke_on_cpu(tmp_path):
    out = tmp_path / "cal.json"
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", "--smoke", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "repro_torch.tune: calibrated cpu x1" in proc.stdout
    _check_structure(load_calibration(str(out)))


def test_calibrate_without_a_card_raises():
    """The entry point runs on the card; without one it raises instead of
    measuring the CPU (only device='cpu' does that)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    from repro_torch.tune.calibrate import calibrate
    from repro_torch.tune.__main__ import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate(smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke", "--no-blocks"])


def test_cli_flags_apply_calibration(tmp_path, capsys):
    import argparse

    from repro_torch.tune import add_calibration_args, apply_calibration_args

    ap = argparse.ArgumentParser()
    add_calibration_args(ap)
    path = save_calibration(make_cal(), str(tmp_path / "cal.json"))
    try:
        assert apply_calibration_args(ap.parse_args([])) is None
        cal = apply_calibration_args(ap.parse_args(["--calibrate", "load", "--calibration-file", path]))
        assert cal == make_cal() and current_calibration() == cal
    finally:
        set_calibration(None)
    assert "loaded" in capsys.readouterr().out


def test_port_tune_package_exports():
    import repro_torch.tune as tune

    for name in tune.__all__:
        assert getattr(tune, name) is not None
    with pytest.raises(AttributeError):
        tune.nope  # noqa: B018
    assert repro_torch.GemmPolicy is GemmPolicy
