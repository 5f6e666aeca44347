"""The benchmark's import boundary: nothing under perfbench/ imports JAX
or the JAX package (compared by whole top-level names, so the port,
``repro_torch``, is not ``repro``), and the plain reference imports
nothing of the program, directly or through the harness's modules."""
import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imports(path: pathlib.Path):
    """Every module ``path`` imports, as written (relative ones resolved
    against the perfbench package)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = path.relative_to(BENCH.parent).parent.parts
                base = base[:len(base) - node.level + 1]
                mod = ".".join(base + ((node.module,) if node.module else ()))
            else:
                mod = node.module
            out.add(mod)
            out |= {f"{mod}.{a.name}" for a in node.names}
    return out


def _file_of(mod: str):
    parts = mod.split(".")
    for n in range(len(parts), 1, -1):
        p = BENCH.parent.joinpath(*parts[:n])
        if p.with_suffix(".py").exists():
            return p.with_suffix(".py")
        if (p / "__init__.py").exists():
            return p / "__init__.py"
    return None


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_and_no_jax_package(path):
    tops = {m.split(".")[0] for m in imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_top_level_name_is_compared_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.models".split(".")[0] in FORBIDDEN


REFERENCE = sorted((BENCH / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[p.name for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    seen, todo = set(), [path]
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for mod in imports(p):
            assert mod.split(".")[0] != "repro_torch", (p, mod)
            if mod.split(".")[0] == "perfbench":
                f = _file_of(mod)
                if f is not None:
                    todo.append(f)
    assert BENCH / "weights.py" in seen or path.name == "__init__.py"
