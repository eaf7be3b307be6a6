"""Nothing the benchmark's command runs loads JAX or the JAX package, the
reference loads nothing of the program, and without a card the command
exits non-zero and prints no result."""
import os
import subprocess
import sys

from benchmark.harness.registry import ROOT
from benchmark.harness.runner import forbidden_modules


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["mdm_tpu_torch", "mdm_tpu_torch.ops", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["mdm_tpu.models", "jax", "jaxlib.xla_client", "flax"]) == [
        "flax", "jax", "jaxlib", "mdm_tpu"]


def _loaded_after(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def test_the_command_loads_no_jax():
    code = ("import benchmark.run\n"
            "from benchmark.harness.registry import Registry\n"
            "reg = Registry()\n"
            "for w in reg.bench['workloads']: reg.traffic(reg.cell(w['name'])['kind'])\n"
            "for m in reg.bench['per_layer']: reg.reader(m['name'])\n"
            "import benchmark.control\n"
            "import mdm_tpu_torch.sampling.pipeline, mdm_tpu_torch.train.train_step\n"
            "import mdm_tpu_torch.models.text_encoders\n")
    assert forbidden_modules(_loaded_after(code)) == []


def test_the_reference_loads_nothing_of_the_program():
    code = ("import benchmark.reference.models, benchmark.reference.train, "
            "benchmark.reference.diffusion, benchmark.reference.hml, benchmark.counts.flops\n")
    loaded = _loaded_after(code)
    assert not [m for m in loaded if m.split(".")[0] in ("mdm_tpu_torch", "mdm_tpu", "jax")]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "mdm_humanml.generate_b128", "--seed", str(2 ** 40), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
