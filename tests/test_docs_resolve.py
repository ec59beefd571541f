"""Every file path claimed in a module docstring must exist in the tree.

Guards against doc rot of the kind the round-3 review flagged: a docstring
citing a repo module (e.g. ``ops/radix_sort.py``) that was never
written.  Reference citations (``*.comp``, ``*.hpp``, ``*.inl``, ``*.glsl``,
``*.cu``) are exempt — those name files in /root/reference, cited as
file:line design rationale.
"""

import ast
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "radx_tpu"

# repo-relative python/tooling paths a docstring may claim
_CLAIM = re.compile(
    r"(?<![\w/.-])((?:radx_tpu|kernels|ops|parallel|oracle|utils|runtime|"
    r"tests|tools|cpp|examples)/[\w./-]+?\.(?:py|cc|md))(?![\w/-])"
)


def _module_docstrings():
    for path in sorted(PKG.rglob("*.py")) + sorted(REPO.glob("*.py")):
        tree = ast.parse(path.read_text())
        doc = ast.get_docstring(tree)
        if doc:
            yield path, doc


def _resolves(claim: str) -> bool:
    if (REPO / claim).exists():
        return True
    # paths are often cited package-relative (ops/core.py)
    return (PKG / claim).exists()


@pytest.mark.parametrize(
    "path,doc",
    list(_module_docstrings()),
    ids=lambda v: str(v).replace(str(REPO) + "/", "") if isinstance(v, pathlib.Path) else "",
)
def test_docstring_paths_resolve(path, doc):
    missing = [c for c in _CLAIM.findall(doc) if not _resolves(c)]
    assert not missing, (
        f"{path} docstring cites nonexistent repo paths: {missing}"
    )
