"""What the package needs from its environment: the compile-cache location
and the imports it may rely on."""

import os
import subprocess
import sys

import jax

from spinglass_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class TestCompileCache:
    def test_env_dir_leaves_jax_setting_alone(self, monkeypatch):
        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/tmp/elsewhere")
        assert cache.enable_persistent_compile_cache() == "/tmp/elsewhere"
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_fixed_dir_in_checkout(self, monkeypatch):
        before = jax.config.jax_compilation_cache_dir
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        try:
            got = cache.enable_persistent_compile_cache()
            assert got == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def test_imports_without_flax_or_click():
    """The main path imports with flax and click unimportable (the card's
    machine is only sure to have JAX, numpy, scipy, optax and chex)."""
    code = (
        "import sys\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['click'] = None\n"
        "import spinglass_tpu, spinglass_tpu.anneal.pt, spinglass_tpu.rl.ppo\n"
        "import spinglass_tpu.distributed.pt_sharded\n"
        "import spinglass_tpu.benchmarks.headline\n"
        "print('ok')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")


def test_features_report_gpu_and_kernel_route():
    import spinglass_tpu

    feats = spinglass_tpu.get_available_features()
    assert feats["backend"] == jax.default_backend()
    assert feats["gpu"] is False
    assert feats["dense_kernel"] == "xla"
