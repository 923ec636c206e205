"""The PyTorch port imports neither jax nor the JAX package (the machine
with the card has no jax), nor PIL or matplotlib, and opens no file of the
JAX package or of the repository's native/ directory. Every module of the port is
imported in a fresh interpreter, which then must not have loaded any of
them."""
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
slice6 = {"dataio.png", "dataio.datasets", "dataio.native_loader",
          "dataio.fixtures", "evaluation.rpe", "examples", "examples._util",
          "examples.rgbd_tum", "examples.stereo_kitti", "examples.stereo_euroc",
          "examples.mono_tum", "examples.mono_kitti", "examples.mono_euroc"}
slice7 = {"parallel", "parallel.dist_ba", "parallel.dist_pose_graph",
          "parallel.multi_seq", "parallel.launch", "visualization",
          "visualization.frame_drawer", "visualization.map_drawer",
          "visualization.ar", "visualization.viewer", "examples.mono_ar",
          "examples.train_vocab"}
slice8 = {"evaluation.trajectory", "examples.eval_street",
          "examples.eval_vocab", "examples.run_fixture_eval"}
slice10 = {"ops.orb"}
missing = (slice5 | slice6 | slice7 | slice8 | slice10) - {
    n.split(".", 1)[1] for n in names}
assert not missing, missing
bad = [m for m in sys.modules
       if m == "jax" or m.startswith(("jax.", "jaxlib", "orb_slam2_with_comment_tpu."))
       or m == "orb_slam2_with_comment_tpu" or m == "PIL" or m.startswith("PIL.")
       or m == "matplotlib" or m.startswith("matplotlib.")]
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
    for p in _port_sources(".cu") + _port_sources(".cc"):
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


NATIVE_DIR = re.compile(r"""['"]native['"/]""")


def test_port_opens_no_path_under_native():
    """Outside comments and docstrings no source of the port names the
    repository's native/ directory; the frame loader the port builds is its
    own csrc/frame_loader.cc."""
    from orb_slam2_with_comment_tpu_torch.dataio import native_loader
    bad = [os.path.relpath(p, ROOT) for p in _port_sources(".py")
           if NATIVE_DIR.search(_code_text(p))]
    assert not bad, bad
    assert os.path.samefile(native_loader._SRC,
                            os.path.join(PORT, "csrc", "frame_loader.cc"))


@pytest.mark.parametrize("rel, module, attr", [
    ("place/data/vocab_default.npz", "place.vocabulary", "DEFAULT_PATH"),
    ("place/data/vocab_10k.npz", "place.vocabulary", "VOCAB_10K_PATH"),
    ("frontend/data/brief_pattern.npy", "ops.brief", "PATTERN_PATH"),
])
def test_packaged_data_is_the_jax_packages(rel, module, attr):
    """The port ships its own copies of the vocabularies and of the BRIEF
    pattern, byte for byte the JAX package's, and loads those."""
    import importlib
    mod = importlib.import_module(
        "orb_slam2_with_comment_tpu_torch." + module)
    mine = os.path.join(PORT, rel)
    theirs = os.path.join(ROOT, "orb_slam2_with_comment_tpu", rel)
    assert os.path.samefile(getattr(mod, attr), mine)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


# what the JAX subpackages export that the port does not have yet: nothing
NOT_YET_PORTED: dict = {}


def _jax_exports(init_path: str) -> list[str]:
    """The names a JAX ``__init__.py`` imports, read with ast (importing
    it would load jax)."""
    with open(init_path) as f:
        tree = ast.parse(f.read())
    return [a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names]


def test_subpackages_export_the_jax_names():
    """Every name a JAX subpackage's ``__init__.py`` exports is exported by
    the port's subpackage of the same name, or listed as not yet ported."""
    import importlib
    jax_dir = os.path.join(ROOT, "orb_slam2_with_comment_tpu")
    subs = sorted(d for d in os.listdir(jax_dir)
                  if os.path.exists(os.path.join(jax_dir, d, "__init__.py")))
    assert len(subs) >= 13, subs
    missing = []
    for sub in subs:
        if sub in NOT_YET_PORTED and NOT_YET_PORTED[sub] is None:
            continue
        port = importlib.import_module(
            "orb_slam2_with_comment_tpu_torch." + sub)
        skip = NOT_YET_PORTED.get(sub) or set()
        names = _jax_exports(os.path.join(jax_dir, sub, "__init__.py"))
        assert names, sub
        missing += [f"{sub}.{n}" for n in names
                    if n not in skip and not hasattr(port, n)]
    assert not missing, missing
