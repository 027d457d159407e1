"""The port-wide import rule: every module of irm_motion_planning_tpu_torch
imports in an interpreter where ``jax`` and the JAX package cannot be
imported at all (a ``sys.meta_path`` finder raises for them).  matplotlib
is allowed (the visualization imports it lazily anyway)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = r'''
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "irm_motion_planning_tpu")


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, Block())
import irm_motion_planning_tpu_torch as pkg

names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
    pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print(len(names))
'''


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", GUARD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    # The package's modules, the new ones among them.
    assert int(out.stdout.split()[-1]) >= 40
