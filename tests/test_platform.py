"""Platform plumbing: the device-kind peak table, the compile cache, the
stdlib-only import and config, sharded parameter creation, the flash
wrapper's argument mapping and the chip_smoke.py rehearsal."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
H100 = "NVIDIA H100 80GB HBM3"


# ---------------------------------------------------------------------------
# peak table


def test_peak_table_h100_datasheet():
    from mlio_tpu.utils.peaks import device_peaks

    p = device_peaks(H100)
    assert p.bf16_flops == 989e12
    assert p.int8_ops == p.fp8_flops == 1979e12
    assert p.hbm_bytes_per_s == 3.35e12 and p.hbm_bytes == 80e9
    assert p.link_bytes_per_s == 450e9


@pytest.mark.parametrize("kind", ["AMD Instinct MI300X", "NVIDIA A100-SXM4-80GB", ""])
def test_unknown_device_kind_raises(kind):
    from mlio_tpu.utils.peaks import device_peaks

    with pytest.raises(KeyError):
        device_peaks(kind)


def test_peaks_default_to_the_running_device():
    from mlio_tpu.utils.peaks import PEAKS, device_peaks

    assert device_peaks() is PEAKS[jax.devices()[0].device_kind]


def test_hardware_spec_reads_the_table():
    from mlio_tpu.parallel.auto_config import HardwareSpec, detect_hardware

    hw = HardwareSpec(kind=H100, num_chips=4)
    assert hw.peak_tflops == 989.0 and hw.hbm_gb == 80.0
    assert hw.hbm_gbps == 3350.0 and hw.link_gbps == 450.0
    assert detect_hardware().kind == "cpu"
    with pytest.raises(KeyError):
        HardwareSpec(kind="mystery", num_chips=1).peak_tflops


def test_utilization_metrics_use_the_table():
    from mlio_tpu.benchmarks import metrics

    assert metrics.flops_utilization(989e12, 1.0, kind=H100) == \
        pytest.approx(1.0)
    assert metrics.bandwidth_utilization(3.35e12 / 2, 1.0, kind=H100) == \
        pytest.approx(0.5)
    with pytest.raises(KeyError):
        metrics.flops_utilization(1.0, 1.0, kind="mystery")


def test_bottleneck_ridge_from_the_table():
    from mlio_tpu.profiling.bottleneck import (BottleneckAnalyzer,
                                               BottleneckType)

    ana = BottleneckAnalyzer(kind=H100)
    assert ana.peak_flops / ana.hbm_bps == pytest.approx(989 / 3.35)
    # 200 FLOP/byte is below the H100 ridge (~295): memory-bound there
    rep = ana.analyze(wall_time_s=3.1e-4, flops=2e11, bytes_accessed=1e9)
    assert rep.primary.kind == BottleneckType.MEMORY
    # 400 FLOP/byte is above it: compute-bound
    rep = ana.analyze(wall_time_s=4.1e-4, flops=4e11, bytes_accessed=1e9)
    assert rep.primary.kind == BottleneckType.COMPUTE


# ---------------------------------------------------------------------------
# compile cache


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_default_is_repo_dir(monkeypatch, restore_cache_dir):
    from mlio_tpu.utils.device_utils import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_env_var_wins(monkeypatch, restore_cache_dir):
    from mlio_tpu.utils.device_utils import enable_compile_cache

    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert enable_compile_cache() == "/somewhere/else"
    # nothing set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_dir_is_gitignored():
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


# ---------------------------------------------------------------------------
# stdlib-only import and CLI


def _fresh(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_needs_no_pydantic_or_yaml():
    r = _fresh("import sys, mlio_tpu, mlio_tpu.config, mlio_tpu.models, "
               "mlio_tpu.runtime\n"
               "bad = [m for m in ('pydantic', 'yaml', 'pandas', "
               "'matplotlib') if m in sys.modules]\n"
               "print(bad); sys.exit(1 if bad else 0)")
    assert r.returncode == 0, r.stdout + r.stderr


def test_cli_help_needs_no_pydantic_or_yaml():
    r = _fresh("import sys, runpy\n"
               "sys.modules['pydantic'] = None; sys.modules['yaml'] = None\n"
               "sys.argv = ['main.py', '--help']\n"
               "try:\n    runpy.run_path('main.py', run_name='__main__')\n"
               "except SystemExit as e:\n    sys.exit(e.code)")
    assert r.returncode == 0, r.stderr
    assert "--attention" in r.stdout and "--kernels" not in r.stdout


# ---------------------------------------------------------------------------
# config (stdlib dataclasses, JSON files)


def test_config_defaults_validate_and_match_shipped_json():
    from mlio_tpu.config import OptimizerConfig, load_config

    shipped = load_config(REPO / "mlio_tpu" / "config" /
                          "default_config.json")
    assert shipped == OptimizerConfig()
    assert shipped.hardware.platform == "gpu"
    assert shipped.hardware.chip_type == H100


def test_config_json_roundtrip(tmp_path):
    from mlio_tpu.config import OptimizerConfig, load_config, save_config

    cfg = OptimizerConfig()
    cfg.benchmark.batch_sizes = [2, 4]
    cfg.kernels.attention = "flash"
    save_config(cfg, tmp_path / "c.json")
    assert json.loads((tmp_path / "c.json").read_text())["kernels"][
        "attention"] == "flash"
    assert load_config(tmp_path / "c.json") == cfg


@pytest.mark.parametrize("raw", [
    {"bogus": {}},
    {"model": {"nmae": "gpt2"}},
    {"hardware": {"num_chips": 0}},
    {"hardware": {"platform": "rocm"}},
    {"kernels": {"attention": "fused"}},
    {"hardware": {"memory_fraction": 1.5}},
    {"parallelism": {"tensor_parallel_size": 4}},  # world 4 > 1 chip
], ids=["section", "key", "chips", "platform", "attention", "fraction",
        "world"])
def test_config_rejects_invalid(raw):
    from mlio_tpu.config import OptimizerConfig

    with pytest.raises(ValueError):
        OptimizerConfig.from_dict(raw)


def test_optimized_config_fits_the_chips():
    from mlio_tpu.config import get_optimized_config

    cfg = get_optimized_config("llama3-8b", num_chips=4)
    assert cfg.parallelism.tensor_parallel_size == 4
    assert cfg.parallelism.world_size == 4


# ---------------------------------------------------------------------------
# parameters created where they live


def test_sharded_init_matches_eager_init():
    from jax.sharding import NamedSharding

    from mlio_tpu.models import get_spec, init_params
    from mlio_tpu.parallel import make_mesh
    from mlio_tpu.parallel.tensor_parallel import init_sharded_params

    spec = get_spec("llama-tiny")
    key = jax.random.PRNGKey(3)
    eager = init_params(spec, key, dtype=jnp.bfloat16)
    mesh = make_mesh(tensor=2, devices=jax.devices()[:2])
    sharded = init_sharded_params(spec, key, jnp.bfloat16, mesh)
    plain = init_sharded_params(spec, key, jnp.bfloat16)
    for a, b, c in zip(jax.tree_util.tree_leaves(eager),
                       jax.tree_util.tree_leaves(sharded),
                       jax.tree_util.tree_leaves(plain)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(c, np.float32))
    wq = sharded["blocks"]["wq"]
    assert isinstance(wq.sharding, NamedSharding)
    assert wq.sharding.spec == jax.sharding.PartitionSpec(None, None,
                                                          "tensor")
    assert wq.addressable_shards[0].data.shape[-1] == spec.q_dim // 2


def test_load_model_seed_gives_reproducible_weights():
    from mlio_tpu.models import load_model

    _, a = load_model("llama-tiny", dtype=jnp.float32, seed=1)
    _, b = load_model("llama-tiny", dtype=jnp.float32, seed=1)
    _, c = load_model("llama-tiny", dtype=jnp.float32, seed=2)
    np.testing.assert_array_equal(np.asarray(a["blocks"]["wq"]),
                                  np.asarray(b["blocks"]["wq"]))
    assert not np.array_equal(np.asarray(a["blocks"]["wq"]),
                              np.asarray(c["blocks"]["wq"]))


# ---------------------------------------------------------------------------
# the flash wrapper's argument mapping onto jax.nn.dot_product_attention


def _captured(monkeypatch, **kw):
    from mlio_tpu.ops import flash_attention as fa

    seen = {}

    def fake(q, k, v, **kwargs):
        seen.update(kwargs)
        return q

    monkeypatch.setattr(fa.jax.nn, "dot_product_attention", fake)
    q = jnp.zeros((2, 4, 4, 16))
    k = jnp.zeros((2, 6, 2, 16))
    fa.flash_attention(q, k, k, **kw)
    return seen


def test_flash_mapping_causal_from_zero(monkeypatch):
    seen = _captured(monkeypatch, causal=True)
    assert seen["is_causal"] and seen["mask"] is None
    assert seen["key_value_seq_lengths"] is None
    assert seen["implementation"] == "cudnn"


def test_flash_mapping_offset_becomes_mask(monkeypatch):
    seen = _captured(monkeypatch, causal=True, q_offset=2, interpret=True)
    assert not seen["is_causal"] and seen["implementation"] == "xla"
    m = np.asarray(seen["mask"])[0, 0]
    assert m.shape == (4, 6)
    # query i sees keys 0 .. 2 + i
    assert [int(r.sum()) for r in m] == [3, 4, 5, 6]


@pytest.mark.parametrize("kv_len", [5, [3, 6]], ids=["scalar", "per-row"])
def test_flash_mapping_kv_lengths(monkeypatch, kv_len):
    seen = _captured(monkeypatch, causal=False, kv_len=jnp.asarray(kv_len))
    lens = seen["key_value_seq_lengths"]
    assert lens.dtype == jnp.int32 and lens.shape == (2,)
    assert not seen["is_causal"] and seen["mask"] is None


@pytest.mark.parametrize("q_offset", [0, 3, "traced"])
@pytest.mark.parametrize("kv_len", [None, "per-row"])
def test_flash_wrapper_matches_reference(q_offset, kv_len):
    from mlio_tpu.ops.flash_attention import flash_attention
    from mlio_tpu.ops.reference import attention_reference

    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(ks[0], (2, 5, 4, 16))
    k = jax.random.normal(ks[1], (2, 12, 2, 16))
    v = jax.random.normal(ks[2], (2, 12, 2, 16))
    lens = None if kv_len is None else jnp.asarray([9, 12], jnp.int32)
    off = 3 if q_offset == "traced" else q_offset

    def run(off_arg):
        return flash_attention(q, k, v, causal=True, q_offset=off_arg,
                               kv_len=lens, interpret=True)

    out = (jax.jit(run)(jnp.int32(off)) if q_offset == "traced"
           else run(off))
    ref = attention_reference(q, k, v, causal=True, q_offset=off,
                              kv_len=lens)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# chip_smoke.py


def _smoke(*args, env_extra=None, cwd=REPO, script=REPO / "chip_smoke.py"):
    env = dict(os.environ, **(env_extra or {}))
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, str(script), *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


@pytest.mark.parametrize("extra", [[], ["--four-cards"]],
                         ids=["one-card", "four-cards"])
def test_chip_smoke_rehearsal(tmp_path, extra):
    r = _smoke("--rehearse", "--out-dir", str(tmp_path), *extra)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "cpu", "kind": "cpu", "count": 4 if extra else 1}}
    assert lines[-2].startswith("card: ")
    phases = {ln.split("]")[0] + "]" for ln in lines if ln.startswith("[")}
    want = ({"[device]", "[four-cards]"} if extra else
            {"[device]", "[kernels]", "[generate]", "[engine]", "[cli]"})
    assert want <= phases, phases


def test_chip_smoke_refuses_the_cpu():
    r = _smoke(env_extra={"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    r = _smoke("--rehearse", cwd=tmp_path, script=lone,
               env_extra={"JAX_PLATFORMS": "cpu", "PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
