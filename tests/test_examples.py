"""The examples/ scripts run end to end (they double as API smoke)."""

import os
import subprocess
import sys

import pytest

_EX = os.path.join(os.path.dirname(__file__), "..", "examples")


@pytest.mark.parametrize("script,args", [
    ("basic_join.py", ["20000", "80000"]),
    ("dataframe_style.py", []),
    ("out_of_core.py", None),  # gets a tmp spill dir
    ("multichip.py", []),
    ("aggregate.py", ["60000"]),
])
def test_example_runs(script, args, tmp_path):
    if args is None:
        args = [str(tmp_path)]
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    # force CPU inside the subprocess (a -c preamble applies the config
    # before the script imports anything)
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        f"exec(open({os.path.join(_EX, script)!r}).read())"
    )
    r = subprocess.run([sys.executable, "-c", code, *args],
                       env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
