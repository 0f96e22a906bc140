"""The port's examples (`examples/torch_*.py`) run with ``--device cpu``.

One subprocess (a module fixture: the torch import paid once) runs each
twin as ``__main__`` in turn, as its command line would, and reports per
example whether it raised and whether `jax` (or `repro`) was imported by
then.  Each test holds one example to: it ran to its end, printed the
checks its reference prints, and imported no JAX.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

# each twin, its arguments beyond --device cpu (train: a few small steps),
# and lines its output must hold (the reference example's checks)
EXAMPLES = {
    "torch_quickstart": ([], ["DGEMM emulation max rel err:", "kernel path bitwise == reference (f32): True",
                              "fp8 engine bitwise == int8 kernels: True",
                              "sharded over 1 rank(s) bitwise == kernel: True"]),
    "torch_spectral_complex": ([], ["emulated-vs-native rel err:", "prepared-operand (amortized F, F^H) rel err:"]),
    "torch_serve_lm": (["--batch", "2", "--prompt-len", "8", "--new-tokens", "4"], ["generated (2, 4)"]),
    "torch_train_lm": (["--steps", "2", "--batch", "2", "--seq", "16"], ["done: loss", "over 2 steps"]),
}

RUNNER = r"""
import contextlib, io, json, runpy, sys, traceback
out = {}
for name, argv in json.loads(sys.argv[1]).items():
    sys.argv = [name + ".py", "--device", "cpu"] + argv
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(sys.argv[0].replace(name, "examples/" + name), run_name="__main__")
        err = None
    except BaseException:
        err = traceback.format_exc()
    out[name] = {"stdout": buf.getvalue(), "error": err,
                 "foreign": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    argv = {name: args + (["--ckpt-dir", str(tmp / "ck")] if name == "torch_train_lm" else [])
            for name, (args, _) in EXAMPLES.items()}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", TMPDIR=str(tmp))
    proc = subprocess.run([sys.executable, "-c", RUNNER, json.dumps(argv)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu_without_jax(runs, name):
    res = runs[name]
    assert res["error"] is None, res["error"]
    assert res["foreign"] == [], f"{name} imported {res['foreign']}"
    for line in EXAMPLES[name][1]:
        assert line in res["stdout"], res["stdout"]
