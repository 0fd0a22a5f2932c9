"""The device route's contracts that hold on any platform: one device DP
backend, no Pallas code for a machine other than a GPU, one process per
accelerator in module A, the compile-cache location, and the on-card
smoke script's refusal to run anywhere but a GPU."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_cli_refuses_pallas_dp_backend(capsys):
    from mandalorion_tpu.pipeline.cli import build_parser
    with pytest.raises(SystemExit):
        build_parser().parse_args(["-p", ".", "--dp_backend", "pallas"])
    assert "invalid choice" in capsys.readouterr().err
    args = build_parser().parse_args(["-p", ".", "--dp_backend", "rowscan"])
    assert args.dp_backend == "rowscan"


def test_aligner_refuses_unknown_dp_backend():
    from mandalorion_tpu.align.aligner import SpliceAligner
    from mandalorion_tpu.config import AlignConfig
    with pytest.raises(ValueError, match="dp_backend"):
        SpliceAligner({"chr1": "ACGT" * 100}, AlignConfig(dp_backend="pallas"))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            for alias in node.names:
                yield f"{node.module}.{alias.name}"


# the Pallas lowerings that target a GPU; any other backend module of
# Pallas is machine-specific code the device route cannot run
GPU_PALLAS = ("jax.experimental.pallas.triton",
              "jax.experimental.pallas.mosaic_gpu")


def test_pallas_imports_are_gpu_routes_only():
    found = []
    for top in ("mandalorion_tpu", "tests", "tools"):
        for root, _dirs, files in os.walk(os.path.join(REPO, top)):
            for f in files:
                if f.endswith(".py"):
                    path = os.path.join(root, f)
                    found += [(path, m) for m in _imports(path)
                              if m.startswith("jax.experimental.pallas.")
                              and not m.startswith(GPU_PALLAS)]
    assert not found


_FORK_PROBE = r"""
import multiprocessing, os, sys, tempfile
from mandalorion_tpu.config import AlignConfig, PipelineConfig
from mandalorion_tpu.pipeline.stages import Paths, module_a
from mandalorion_tpu.utils.simulate import make_dataset
forks = []
orig = multiprocessing.get_context
def get_context(method=None):
    forks.append(method)
    return orig(method)
multiprocessing.get_context = get_context
device = sys.argv[1] == "device"
align = (AlignConfig(batch_reads=16, chain_backend="device",
                     dp_backend="rowscan") if device
         else AlignConfig(batch_reads=16))
with tempfile.TemporaryDirectory() as tmp:
    make_dataset(tmp, n_genes=2, n_reads_per_gene=32, genome_len=20_000)
    paths = Paths(os.path.join(tmp, "out"))
    os.makedirs(paths.tmp)
    module_a(paths, PipelineConfig(threads=2, align=align),
             os.path.join(tmp, "reads.fasta"),
             os.path.join(tmp, "genome.fasta"))
    n = sum(1 for _ in open(paths.t("mm2Alignments.psl")))
print("FORKS", forks.count("fork"), "PSL", n)
"""


@pytest.mark.parametrize("backend,forks", [("device", 0), ("host", 1)])
def test_module_a_forks_only_without_device_backend(tmp_path, backend,
                                                    forks):
    """With a device backend, module A at -t 2 keeps every dispatch in
    its own process (the backend comes up when the aligner is built, so
    no worker opens the accelerator); the host route still forks."""
    if (os.cpu_count() or 1) < 2:
        pytest.skip("needs 2 cores for a 2-worker pool")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _FORK_PROBE, backend],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("FORKS")][-1]
    _tag, n_forks, _p, n_psl = line.split()
    assert int(n_forks) == forks
    assert int(n_psl) > 0


_CACHE_PROBE = ("import jax; from mandalorion_tpu.runtime import "
                "enable_compilation_cache as e; print(e()); "
                "print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("from_env", [True, False])
def test_compilation_cache_location(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR, when set, is the only cache directory;
    otherwise the cache is <repo>/.jax_cache whatever the working
    directory."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    want = os.path.join(REPO, ".jax_cache")
    if from_env:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    res = subprocess.run([sys.executable, "-c", _CACHE_PROBE],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    returned, configured = res.stdout.split()[-2:]
    assert returned == configured == want


def test_chip_smoke_fails_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "not a GPU" in res.stderr


def test_compare_outputs_catches_one_byte(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    for name in chip_smoke.OUTPUT_FILES:
        (a / name).write_bytes(b"Isoform1_5\tchr1\t100\n")
        (b / name).write_bytes(b"Isoform1_5\tchr1\t100\n")
    assert chip_smoke.compare_outputs(str(a), str(b)) == []
    name = chip_smoke.OUTPUT_FILES[3]
    (b / name).write_bytes(b"Isoform1_5\tchr1\t101\n")
    assert chip_smoke.compare_outputs(str(a), str(b)) == [name]
    (b / name).unlink()
    assert chip_smoke.compare_outputs(str(a), str(b)) == [name]


def test_chain_costs_round_like_numpy():
    """The chain kernel's float32 gap costs equal numpy's separately
    rounded multiply and add at every gap size and exponent (XLA's CPU
    backend would otherwise fuse them into one FMA)."""
    assert chip_smoke.check_chain_costs() == 400_001 + 64
