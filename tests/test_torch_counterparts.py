"""Every Python file of the JAX package (``speedplusbaseline_tpu/``) and of
its ``scripts/`` has a counterpart in the port (``speedplusbaseline_tpu_torch/``)
or a stated reason for having none, and so has each user-facing entry point
at the repository root. The table below is the claim; the tests
walk both trees, so a JAX file without a row, a row without a JAX file, or a
counterpart that does not exist fails."""
import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "speedplusbaseline_tpu_torch"

# Reasons a JAX file has no counterpart of its own.
PROFILE = ("a TPU probe or profile: the port's is the profile_step module and "
           "chip_smoke.py's phases")
NEVER_SHIPPED = "a measured TPU dead end, kept for the record and never shipped"

# JAX package: each file under the same path in the port, except the Pallas
# kernels, whose wrappers launch the CUDA kernels of csrc/.
PACKAGE = {
    "ops/pallas_instancenorm.py": "ops/instancenorm.py",
    "ops/pallas_resblock.py": "ops/resblock.py",
}

SCRIPTS = {
    "ab_bf16_out.py": "perf/ab_bf16_out.py",
    "ab_spn_styled.py": "perf/ab_spn_styled.py",
    "bench_e2e.py": "perf/bench_e2e.py",
    "bench_host_loader.py": "perf/bench_host_loader.py",
    "cache_dataset.py": "cache_dataset.py",
    "convergence_run.py": "quality/convergence_run.py",
    "convert_assets.py": "convert_assets.py",
    "convert_ghiasi.py": "convert_weights.py",
    "convert_style_predictor.py": "convert_weights.py",
    "convert_torchvision_mobilenet.py": "convert_weights.py",
    "dann_adaptation_run.py": "quality/dann_adaptation_run.py",
    "dump_krn_backbone.py": "quality/dump_krn_backbone.py",
    "dump_spn_convs.py": "quality/dump_spn_convs.py",
    "get_embedding_mean_and_covariance.py": "embedding.py",
    "krn_transfer_run.py": "quality/krn_transfer_run.py",
    "probe_dw.py": PROFILE,
    "probe_resblock.py": PROFILE,
    "probe_shapes.py": PROFILE,
    "probe_spn_memorize.py": "quality/probe_spn_memorize.py",
    "profile_ghiasi_parts.py": PROFILE,
    "profile_krn_prefix.py": PROFILE,
    "profile_one.py": PROFILE,
    "profile_prefix.py": PROFILE,
    "profile_step.py": "profile_step.py",
    "profile_switch.py": PROFILE,
    "reflect_conv.py": NEVER_SHIPPED,
    "styleaug_ab_run.py": "quality/styleaug_ab_run.py",
    "trace_step.py": PROFILE,
    "train_toy_ghiasi.py": "train_toy_ghiasi.py",
}
REASONS = (PROFILE, NEVER_SHIPPED)

# The user-facing entry points at the repository root and the port modules
# that take their place (``python -m speedplusbaseline_tpu_torch.<module>``).
# The root's other Python files are no user's entry point: chip_smoke.py is
# the port's card check and __graft_entry__.py the JAX package's compile
# check.
ROOT = {
    "adapt.py": "adapt.py",
    "bench.py": "bench.py",
    "preprocess.py": "preprocess.py",
    "test.py": "test.py",
    "train.py": "train.py",
}


@pytest.mark.parametrize("path", sorted(ROOT))
def test_each_root_entry_point_has_a_counterpart(path):
    assert os.path.isfile(os.path.join(REPO, path)), path
    assert os.path.isfile(os.path.join(REPO, PORT, ROOT[path])), (path, ROOT[path])


def package_files():
    root = os.path.join(REPO, "speedplusbaseline_tpu")
    return sorted(os.path.relpath(p, root)
                  for p in glob.glob(os.path.join(root, "**", "*.py"), recursive=True))


def test_the_table_covers_every_jax_file():
    assert sorted(glob.glob(os.path.join(REPO, "scripts", "*.py"))) == sorted(
        os.path.join(REPO, "scripts", name) for name in SCRIPTS)
    assert set(PACKAGE) <= set(package_files())
    assert len(package_files()) >= 50


@pytest.mark.parametrize("path", sorted(SCRIPTS))
def test_each_script_has_a_counterpart_or_a_reason(path):
    target = SCRIPTS[path]
    if target not in REASONS:
        assert os.path.isfile(os.path.join(REPO, PORT, target)), (path, target)


def test_each_package_file_has_a_counterpart():
    missing = [p for p in package_files()
               if not os.path.isfile(os.path.join(REPO, PORT, PACKAGE.get(p, p)))]
    assert not missing, missing
    for kernel in ("instancenorm", "resblock"):
        assert os.path.isfile(os.path.join(REPO, PORT, "csrc", f"{kernel}.cu"))
