"""PyTorch port: the JAX-free modules the port keeps as verbatim copies
of the JAX package's — `config/`, `configs/`, `core/`, `data/` and
`serving/{plane,engine,runtime,costmodel,kv_pool,page_share,metrics,
cluster,workload,e2e}.py` — still equal the reference's.

Each pair of files is compared as syntax trees (`ast.dump`) with every
docstring dropped (the port's name its own module paths) and `repro`
renamed to `repro_torch` in `import` and `from ... import` statements
only, so any change of code, names or literals shows.  The test reads
the reference's source and imports neither module.
"""
import ast
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PACKAGES = ("config", "configs", "core", "data")
SERVING = ("plane", "engine", "runtime", "costmodel", "kv_pool",
           "page_share", "metrics", "cluster", "workload", "e2e")


def _copies():
    """The copied modules, as paths relative to either package."""
    out = []
    for pkg in PACKAGES:
        out += sorted(p.relative_to(SRC / "repro").as_posix()
                      for p in (SRC / "repro" / pkg).glob("*.py"))
    return out + [f"serving/{m}.py" for m in SERVING]


def _renamed(name):
    if name == "repro" or name.startswith("repro."):
        return "repro_torch" + name[len("repro"):]
    return name


class _Normalise(ast.NodeTransformer):
    """Drop docstrings; rename the package in import statements."""

    def _drop_doc(self, node):
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        self.generic_visit(node)
        return node

    visit_Module = visit_ClassDef = _drop_doc
    visit_FunctionDef = visit_AsyncFunctionDef = _drop_doc

    def visit_Import(self, node):
        for alias in node.names:
            alias.name = _renamed(alias.name)
        return node

    def visit_ImportFrom(self, node):
        if node.module is not None:
            node.module = _renamed(node.module)
        return node


def _dump(source, rename):
    """`ast.dump` of `source`, docstrings dropped; `rename`: the package
    renamed in its imports (the reference's side)."""
    norm = _Normalise()
    if not rename:          # the port's own imports stay as they are
        norm.visit_Import = norm.visit_ImportFrom = lambda node: node
    return ast.dump(norm.visit(ast.parse(source)))


@pytest.mark.parametrize("rel", _copies())
def test_port_copy_equals_reference(rel):
    """The port's copy and the reference's module have the same syntax
    tree, docstrings aside and with the package renamed in imports."""
    ref, port = SRC / "repro" / rel, SRC / "repro_torch" / rel
    assert port.exists(), f"{rel}: the port has no copy"
    assert _dump(port.read_text(), False) == _dump(ref.read_text(), True), (
        f"{rel}: the port's copy differs from the reference beyond "
        f"docstrings and the package name in imports")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_copied_packages_hold_the_same_modules(pkg):
    """No module was added to or left out of a copied package."""
    names = {p: sorted(q.name for q in (SRC / p / pkg).glob("*.py"))
             for p in ("repro", "repro_torch")}
    assert names["repro"] == names["repro_torch"]


def test_normalisation_sees_code_changes():
    """The comparison is not blind: a changed literal, a changed name
    and a changed import each make two trees differ, while a changed
    docstring and the package rename do not."""
    ref = ('"""a"""\nfrom repro.core import x\n'
           'def f():\n    """b"""\n    return x + 1\n')
    same = ('"""c"""\nfrom repro_torch.core import x\n'
            'def f():\n    """d"""\n    return x + 1\n')
    assert _dump(same, False) == _dump(ref, True)
    for bad in (same.replace("+ 1", "+ 2"), same.replace("def f", "def g"),
                same.replace("core import", "serving import")):
        assert _dump(bad, False) != _dump(ref, True)
