"""The port imports no JAX and builds nothing at import time."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CODE = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import qilaplace_tpu_torch
import qilaplace_tpu_torch.ops.readout_kernels as rk
import qilaplace_tpu_torch.utils.interop
assert not any(m == "jax" or m.startswith(("jax.", "qilaplace_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
assert rk._build.cache_info().currsize == 0  # nothing compiled on import
print("IMPORT_OK")
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PATH=os.pathsep.join(
        p for p in os.environ.get("PATH", "").split(os.pathsep)
        if not os.path.exists(os.path.join(p, "nvcc"))
    ))
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "IMPORT_OK" in proc.stdout
