"""Every public name of the JAX package has its counterpart in the port.

Walks each module and package ``__init__`` of ``fdoct_tpu`` (by its source:
the top-level functions, classes and assignments, and for an ``__init__`` the
names it re-exports from the package) and asserts that the same module of
``fdoct_tpu_torch`` has each name; for a function, and for each public
method and the constructor of a class, that every keyword the JAX signature
takes is accepted by the port's.  Code written against the JAX package's
import paths then runs on the port.

The deliberate exceptions, and nothing else:

- ``fdoct_tpu/ops/pallas_kernels.py``: the TPU kernels; their ports are
  ``fdoct_tpu_torch/ops/kernels.py`` and ``csrc/``;
- ``pipeline.reconstruct_group_pallas``: its port is
  ``pipeline.reconstruct_group``;
- the ``interpret=`` keyword: Pallas's interpret mode; the port's wrappers
  run their plain versions on CPU tensors instead.
"""

import ast
import importlib
import inspect
from pathlib import Path

import pytest

pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "fdoct_tpu"
EXCEPT_MODULES = {"fdoct_tpu.ops.pallas_kernels"}
EXCEPT_NAMES = {"fdoct_tpu.pipeline.reconstruct_group_pallas"}
EXCEPT_KEYWORDS = {"interpret"}


def module_name(path: Path) -> str:
    parts = path.relative_to(ROOT).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


JAX_MODULES = sorted(module_name(p) for p in JAX_PKG.rglob("*.py"))


def public_names(mod: str) -> list[str]:
    """The names the module's source defines at top level; for a package
    ``__init__``, also those it imports from the package."""
    path = ROOT / Path(*mod.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif (isinstance(node, ast.ImportFrom) and path.name == "__init__.py"
              and (node.module or "").startswith("fdoct_tpu")):
            names |= {a.asname or a.name for a in node.names}
    return sorted(n for n in names if not n.startswith("_"))


def keywords(fn) -> set[str] | None:
    """The parameter names ``fn`` takes by keyword, or None when it takes
    ``**kwargs`` (any keyword) or has no readable signature."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return None
    if any(p.kind is p.VAR_KEYWORD for p in params):
        return None
    return {p.name for p in params if p.kind not in (p.VAR_POSITIONAL, p.POSITIONAL_ONLY)}


def missing_keywords(jax_fn, port_fn) -> set[str]:
    want, have = keywords(jax_fn), keywords(port_fn)
    if want is None or have is None:
        return set()
    return want - have - EXCEPT_KEYWORDS - {"self", "cls"}


def callables(jax_obj, port_obj):
    """(label, JAX callable, port callable) pairs to hold: a function
    itself; a class's constructor and public methods."""
    if inspect.isfunction(jax_obj):
        yield "", jax_obj, port_obj
    elif inspect.isclass(jax_obj):
        yield ".__init__", jax_obj, port_obj
        for name, attr in vars(jax_obj).items():
            if name.startswith("_"):
                continue
            if isinstance(attr, (classmethod, staticmethod)) or inspect.isfunction(attr):
                yield f".{name}", getattr(jax_obj, name), getattr(port_obj, name, None)


@pytest.mark.parametrize("mod", [m for m in JAX_MODULES if m not in EXCEPT_MODULES])
def test_port_has_every_public_name(mod):
    jax_mod = importlib.import_module(mod)
    port_mod = importlib.import_module(mod.replace("fdoct_tpu", "fdoct_tpu_torch", 1))
    faults = []
    for name in public_names(mod):
        if f"{mod}.{name}" in EXCEPT_NAMES:
            continue
        if not hasattr(port_mod, name):
            faults.append(f"{name}: missing")
            continue
        for label, jfn, tfn in callables(getattr(jax_mod, name), getattr(port_mod, name)):
            if tfn is None:
                faults.append(f"{name}{label}: missing")
            elif missing := missing_keywords(jfn, tfn):
                faults.append(f"{name}{label}: no keyword {sorted(missing)}")
    assert not faults, f"{mod}: " + "; ".join(faults)


def test_port_cli_has_every_jax_subcommand_and_option():
    """The JAX CLI's subcommands and their options, by name, in the port's
    parser (which adds --device)."""
    from fdoct_tpu.cli import build_parser as jax_parser
    from fdoct_tpu_torch.cli import build_parser as port_parser

    def surface(parser):
        sub = next(a for a in parser._actions if a.choices and isinstance(a.choices, dict))
        return {cmd: {opt for act in sp._actions for opt in act.option_strings}
                for cmd, sp in sub.choices.items()}

    jax_cli, port_cli = surface(jax_parser()), surface(port_parser())
    assert set(jax_cli) <= set(port_cli)
    for cmd, opts in jax_cli.items():
        assert opts <= port_cli[cmd], (cmd, sorted(opts - port_cli[cmd]))


def test_the_exceptions_are_real():
    """Each listed exception names something the JAX package has and the
    port deliberately does otherwise."""
    from fdoct_tpu import int8direct, pipeline

    assert (JAX_PKG / "ops" / "pallas_kernels.py").exists()
    assert not (ROOT / "fdoct_tpu_torch" / "ops" / "pallas_kernels.py").exists()
    assert hasattr(pipeline, "reconstruct_group_pallas")
    assert "interpret" in inspect.signature(int8direct.reconstruct_bscan_int8_fused).parameters


def test_cmd_bench_reaches_the_ports_benchmark(monkeypatch):
    """``bench`` is no exception: the subcommand runs
    ``fdoct_tpu_torch.bench.main`` on ``--device``."""
    import torch

    from fdoct_tpu_torch import bench, cli
    seen = []
    monkeypatch.setattr(bench, "main", lambda device: seen.append(device) or 0)
    assert cli.main(["bench", "--device", "cpu"]) == 0
    assert seen == [torch.device("cpu")]
