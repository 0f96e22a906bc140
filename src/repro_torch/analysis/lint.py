"""Source lints keeping the port's policy surface in sync across the repo.

The port of `repro.analysis.lint`.  Unlike the passes, which certify
traced calls, these parse files:

* the port's `Execution` literal equals `EXECUTIONS` (`core/policy.py`);
* the README's section on the port (from ``## PyTorch/CUDA port (H100)``
  to the next ``## `` heading) names every execution in backticks and
  every field of the port's `GemmPolicy` (the reference's fields but
  ``interpret``);
* every file of `EXECUTION_CLIS` offers exactly `EXECUTIONS` in its
  ``--execution`` flag and has ``--rtol``, the accuracy-adaptive axis;
* no file of `EXECUTION_CLIS` is missing.

`EXECUTION_CLIS` holds the port's CLIs that take an execution.  The
reference's `launch/dryrun.py` and its benchmarks join it when the port
has them (ROADMAP items 13b and 13a).  `python -m repro_torch.analysis`
runs :func:`lint_repo` beside its traced matrix.
"""
from __future__ import annotations

import ast
import dataclasses
import typing
from pathlib import Path

from .passes import Finding

__all__ = ["EXECUTION_CLIS", "PORT_SECTION", "execution_choices", "has_flag", "lint_policy_surface",
           "lint_repo", "port_section"]

#: the port's CLIs that must expose the whole execution axis
EXECUTION_CLIS = (
    "src/repro_torch/launch/train.py",
    "src/repro_torch/launch/serve.py",
)

#: the heading of the README's section on the port
PORT_SECTION = "## PyTorch/CUDA port (H100)"

_LINT = "policy-surface"


def _add_argument_calls(path, flag: str):
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument" and node.args
                and isinstance(node.args[0], ast.Constant) and node.args[0].value == flag):
            yield node


def execution_choices(path) -> list | None:
    """The literal ``choices=[...]`` of the ``--execution`` flag in `path`,
    or None where the file defines no such flag."""
    for node in _add_argument_calls(path, "--execution"):
        for kw in node.keywords:
            if kw.arg == "choices" and isinstance(kw.value, (ast.List, ast.Tuple)):
                return [el.value for el in kw.value.elts if isinstance(el, ast.Constant)]
    return None


def has_flag(path, flag: str) -> bool:
    """True if `path` defines an ``add_argument("<flag>", ...)`` call."""
    return any(True for _ in _add_argument_calls(path, flag))


def port_section(readme: str) -> str | None:
    """The README's section on the port, its heading to the next ``## ``
    heading (or the end); None without one."""
    start = readme.find(PORT_SECTION)
    if start < 0:
        return None
    end = readme.find("\n## ", start + len(PORT_SECTION))
    return readme[start:] if end < 0 else readme[start:end]


def lint_policy_surface(root) -> list:
    """The README's port section and the CLIs against the port's
    `GemmPolicy` and its execution axis."""
    from ..core import policy as policy_mod
    from ..core.policy import EXECUTIONS, GemmPolicy

    root = Path(root)
    findings: list[Finding] = []
    literal = typing.get_args(getattr(policy_mod, "Execution", None))
    if literal and set(literal) != set(EXECUTIONS):
        findings.append(Finding(_LINT, f"core/policy.py: Execution literal {sorted(literal)} != "
                                       f"EXECUTIONS {sorted(EXECUTIONS)}"))

    section = port_section((root / "README.md").read_text())
    if section is None:
        findings.append(Finding(_LINT, f"README.md has no section {PORT_SECTION!r}"))
        section = ""
    for ex in EXECUTIONS:
        if f"`{ex}`" not in section:
            findings.append(Finding(_LINT, f"README.md's port section does not document execution "
                                           f"`{ex}` (every GemmPolicy execution must appear in "
                                           "backticks)"))
    for field in dataclasses.fields(GemmPolicy):
        if field.name not in section:
            findings.append(Finding(_LINT, f"README.md's port section does not mention GemmPolicy "
                                           f"field `{field.name}`"))

    for rel in EXECUTION_CLIS:
        path = root / rel
        if not path.exists():
            findings.append(Finding(_LINT, f"{rel}: file not found"))
            continue
        choices = execution_choices(path)
        if choices is None:
            findings.append(Finding(_LINT, f"{rel}: no --execution argument with literal choices"))
        elif set(choices) != set(EXECUTIONS):
            missing = sorted(set(EXECUTIONS) - set(choices))
            extra = sorted(set(choices) - set(EXECUTIONS))
            detail = ([f"missing {missing}"] if missing else []) + ([f"unknown {extra}"] if extra else [])
            findings.append(Finding(_LINT, f"{rel}: --execution choices out of sync with "
                                           f"GemmPolicy.EXECUTIONS ({'; '.join(detail)})"))
        if not has_flag(path, "--rtol"):
            findings.append(Finding(_LINT, f"{rel}: no --rtol argument (the adaptive accuracy axis, "
                                           "GemmPolicy(rtol=...), must be exposed by every execution "
                                           "CLI)"))
    return findings


def lint_repo(root) -> list:
    """Every source lint of the repo rooted at `root`."""
    return lint_policy_surface(root)
