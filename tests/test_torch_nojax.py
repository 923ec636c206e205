"""The PyTorch port imports neither jax nor the JAX package: the machine
with the card has no jax. Every module of the port is imported in a fresh
interpreter, which then must not have loaded either."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import orb_slam2_with_comment_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 20, names
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
