"""The PyTorch port imports neither jax nor the JAX package: the machine
with the card has no jax. Every module of the port is imported in a fresh
interpreter, which then must not have loaded either."""
import ast
import io
import os
import re
import subprocess
import sys
import tokenize

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import orb_slam2_with_comment_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 20, names
slice5 = {"checkpoint", "nodes", "system", "dataio.settings", "models.camera",
          "place.database", "pipeline.loop_closing", "pipeline.tracking"}
missing = slice5 - {n.split(".", 1)[1] for n in names}
assert not missing, missing
bad = [m for m in sys.modules
       if m == "jax" or m.startswith(("jax.", "jaxlib", "orb_slam2_with_comment_tpu."))
       or m == "orb_slam2_with_comment_tpu"]
assert not bad, bad
print("ok", len(names))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


PORT = os.path.join(ROOT, "orb_slam2_with_comment_tpu_torch")
JAX_NAME = re.compile(r"orb_slam2_with_comment_tpu(?!_torch)")


def _code_text(path: str) -> str:
    """A Python source's tokens without its comments and docstrings."""
    with open(path, "rb") as f:
        src = f.read()
    tree = ast.parse(src)
    doc_lines = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                doc_lines.update(range(body[0].lineno,
                                       body[0].end_lineno + 1))
    keep = []
    for tok in tokenize.tokenize(io.BytesIO(src).readline):
        if tok.type == tokenize.COMMENT:
            continue
        if tok.type == tokenize.STRING and tok.start[0] in doc_lines:
            continue
        keep.append(tok.string)
    return " ".join(keep)


def _port_sources(ext: str) -> list[str]:
    out = []
    for base, _, files in os.walk(PORT):
        out += [os.path.join(base, f) for f in files if f.endswith(ext)]
    return sorted(out)


def test_port_sources_name_no_jax_package():
    """Outside comments and docstrings, no source of the port names the JAX
    package (an import of it, or a path into its directory)."""
    py = _port_sources(".py")
    assert len(py) >= 35, py
    bad = [os.path.relpath(p, ROOT) for p in py
           if JAX_NAME.search(_code_text(p))]
    for p in _port_sources(".cu"):
        with open(p) as f:
            code = re.sub(r"/\*.*?\*/", "", f.read(), flags=re.S)
        code = "\n".join(line.split("//")[0] for line in code.splitlines())
        if JAX_NAME.search(code):
            bad.append(os.path.relpath(p, ROOT))
    assert not bad, bad


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    bad = [m for m in mods if m.split(".")[0] in (
        "jax", "jaxlib", "orb_slam2_with_comment_tpu")]
    assert mods and not bad, bad


@pytest.mark.parametrize("rel, module, attr", [
    ("place/data/vocab_default.npz", "place.vocabulary", "DEFAULT_PATH"),
    ("frontend/data/brief_pattern.npy", "ops.brief", "PATTERN_PATH"),
])
def test_packaged_data_is_the_jax_packages(rel, module, attr):
    """The port ships its own copies of the default vocabulary and of the
    BRIEF pattern, byte for byte the JAX package's, and loads those."""
    import importlib
    mod = importlib.import_module(
        "orb_slam2_with_comment_tpu_torch." + module)
    mine = os.path.join(PORT, rel)
    theirs = os.path.join(ROOT, "orb_slam2_with_comment_tpu", rel)
    assert os.path.samefile(getattr(mod, attr), mine)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
