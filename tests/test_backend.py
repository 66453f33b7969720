"""Platform choices (commonroad_rp_jax.backend) and the refusal of the GPU
smoke test and the benchmark to report a result anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

from commonroad_rp_jax import backend


@pytest.mark.parametrize("platform,want", [
    ("gpu", backend.BackendDefaults(kernel_dtype="float32", fast_scoring=True)),
    ("cpu", backend.BackendDefaults(kernel_dtype="float64",
                                    fast_scoring=False)),
    ("rocm", None),
])
def test_resolve_defaults(platform, want):
    if want is None:
        with pytest.raises(ValueError, match="unsupported JAX platform"):
            backend.resolve_defaults(platform)
    else:
        assert backend.resolve_defaults(platform) == want


def test_resolve_defaults_follows_the_running_backend():
    # the test process is pinned to the CPU (conftest.py)
    assert backend.resolve_defaults() == backend.resolve_defaults("cpu")


@pytest.mark.parametrize("platform,polygons,want", [
    ("gpu", False, "score_fleet_triton"),
    ("gpu", True, "score_fleet"),
    ("cpu", False, "score_fleet"),
])
def test_scorer_choice(platform, polygons, want):
    """The GPU takes the Triton kernel where it covers the obstacle set;
    polygon groups and the CPU take the XLA scorer.  The single-problem
    choice follows the fleet choice."""
    import jax.numpy as jnp

    from commonroad_rp_jax.ops import collision, cycle, triton_scorer

    T = 3
    obstacles = collision.ObstacleArrays(
        pose=jnp.zeros((1, T, 3)), half_ext=jnp.ones((1, 2)),
        valid=jnp.ones((1, T), dtype=bool),
        poly_verts=jnp.zeros((1, T, 3, 2)) if polygons else None,
        poly_valid=jnp.ones((1, T), dtype=bool) if polygons else None)
    fleet = backend.fleet_scorer(obstacles, platform)
    assert fleet.__name__ == want
    single = backend.scorer(obstacles, platform)
    assert single is (cycle.score_candidates if fleet is cycle.score_fleet
                      else triton_scorer.score_candidates_triton)


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(backend.jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert backend.enable_compile_cache() == str(tmp_path)
    assert calls == []                     # JAX reads the variable itself


def test_compile_cache_defaults_to_checkout(monkeypatch, repo_root):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    want = str(repo_root / ".jax_cache")
    assert backend.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in_checkout", "script_alone"])
def test_chip_smoke_refuses_without_gpu(repo_root, tmp_path, alone):
    script = repo_root / "chip_smoke.py"
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_bench_refuses_without_gpu(repo_root, tmp_path):
    """bench.py measures only on a GPU; the CPU runs only when asked for
    by name (``--platform cpu``)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(repo_root / "bench.py")],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 1
    assert "--platform cpu" in proc.stderr
    assert proc.stdout == ""


@pytest.fixture
def gpu_card():
    """Skips unless an NVIDIA card answers (decided here, never at import)."""
    try:
        subprocess.run(["nvidia-smi", "-L"], check=True, capture_output=True,
                       timeout=60)
    except (OSError, subprocess.SubprocessError):
        pytest.skip("no NVIDIA GPU on this host")


@pytest.mark.chip
def test_chip_smoke_passes_on_gpu(repo_root, gpu_card):
    """The whole smoke test on the card (the test process itself stays on
    the CPU, so the child owns the card)."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run([sys.executable, str(repo_root / "chip_smoke.py")],
                          cwd=repo_root, env=env, capture_output=True,
                          text=True, timeout=1500)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1].startswith('{"ok": true')
