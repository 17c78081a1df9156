"""The accelerator a measurement runs on, and where compiled code is kept.

Every script that reports a device number calls `require_gpu` first: a
measurement that finds no GPU fails instead of timing the CPU backend.
`card_line` reads the card's name and power limit from nvidia-smi in a
child process that never touches JAX.  `use_compile_cache` keeps JAX's
persistent compilation cache at one fixed path per checkout.
"""

from __future__ import annotations

import os
import subprocess

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def use_compile_cache() -> str:
    """The persistent compilation cache directory in use.  When
    JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and nothing is
    changed here; otherwise the cache goes to <checkout>/.jax_cache."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> jax.Device:
    """Device 0, which must be a GPU; raises RuntimeError otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {dev.platform!r} "
            f"({dev.device_kind})"
        )
    return dev


def card_line() -> str:
    """`name, power.limit` of every card, one per line, as nvidia-smi
    reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_record() -> dict:
    """The device fields every result line carries."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
