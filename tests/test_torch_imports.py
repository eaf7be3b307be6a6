"""mdm_tpu_torch imports neither jax, flax, optax, orbax nor mdm_tpu: every
module imports, and a tiny generation, a tiny train step and the
command-line path (train -> generate -> edit, and train_evaluators ->
eval_humanml, and the comp_v6 stage, with --device cpu on a synthetic HumanML3D tree; train with
the SMPL loss -> train_evaluators -> eval_a2m on a synthetic HumanAct12 tree
and SMPL pickle; convert_text_encoders -> both embedders, and
convert_checkpoint -> generate with the CLIP tower) run, in a fresh
interpreter where all five are blocked; the parallel package builds a
mesh of one rank and gives a tensor-parallel split there too."""
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "mdm_tpu_torch"

_PROGRAM = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["mdm_tpu"] = None
sys.modules["optax"] = None
sys.modules["orbax"] = None
import torch
import mdm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mdm_tpu_torch.__path__, "mdm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from mdm_tpu_torch.diffusion import Schedule
from mdm_tpu_torch.models import MDM, Conditioning, MDMConfig
from mdm_tpu_torch.sampling import GenerationConfig, MotionGenerator
model = MDM(MDMConfig(latent_dim=64, ff_size=128, num_layers=1, num_heads=2))
model.init_weights(torch.Generator().manual_seed(0))
gen = MotionGenerator(model, Schedule.create("cosine", 100, "2"))
out = gen.generate(Conditioning(text_embed=torch.zeros(1, 512)), 1, 6, torch.Generator())
assert out["joints"].shape == (1, 6, 22, 3) and torch.isfinite(out["joints"]).all()
dip = MDM(MDMConfig(latent_dim=64, ff_size=128, num_layers=1, num_heads=2, arch="trans_dec",
                    text_dim=768, text_tokens=True, context_len=2, pred_len=4))
dip.init_weights(torch.Generator().manual_seed(0))
gen = MotionGenerator(dip, Schedule.create("cosine", 100, "2"),
                      GenerationConfig(sampler="ddim", autoregressive=True))
out = gen.generate(Conditioning(text_embed=torch.zeros(1, 3, 768),
                                prefix=torch.zeros(1, 2, 263)), 1, 6, torch.Generator())
assert out["joints"].shape == (1, 6, 22, 3) and torch.isfinite(out["joints"]).all()
from mdm_tpu_torch.train import OptimConfig, TrainStepConfig, create_train_state, make_train_step
state = create_train_state(model, OptimConfig())
batch = {"x": torch.randn(2, 6, 263), "mask": torch.ones(2, 6, dtype=torch.bool),
         "cond": Conditioning(text_embed=torch.zeros(2, 512))}
state, metrics = make_train_step(Schedule.create("cosine", 100), TrainStepConfig())(state, batch, 0)
assert state.step == 1 and torch.isfinite(metrics["loss"])
from mdm_tpu_torch.parallel import make_mesh, shard_batch
from mdm_tpu_torch.parallel.multihost import maybe_initialize_distributed
from mdm_tpu_torch.parallel.tp_rules import spec_for_param
assert maybe_initialize_distributed() == 0 and make_mesh().size == 1
assert shard_batch(batch)["x"].shape == (2, 6, 263)
assert spec_for_param("seqTransEncoder.layers.0.linear2.weight", 2).dim == 1
import os, tempfile
import numpy as np
from mdm_tpu_torch.cli import edit, generate, train
cwd = os.getcwd()
with tempfile.TemporaryDirectory() as tmp:
    os.chdir(tmp)  # the dataset's parse cache goes under ./save
    root = os.path.join(tmp, "HumanML3D")
    os.makedirs(os.path.join(root, "new_joint_vecs"))
    os.makedirs(os.path.join(root, "texts"))
    rng = np.random.default_rng(1)
    for i in range(3):
        np.save(os.path.join(root, "new_joint_vecs", f"{i:06d}.npy"),
                rng.normal(size=(int(rng.integers(45, 80)), 263)).astype(np.float32))
        with open(os.path.join(root, "texts", f"{i:06d}.txt"), "w") as f:
            f.write("a person walks#a/DET person/NOUN walk/VERB#0.0#0.0\n")
    for split in ("train", "test"):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(f"{i:06d}" for i in range(3)))
    tiny = ["--latent_dim", "32", "--layers", "1", "--diffusion_steps", "4", "--device", "cpu"]
    train.main(["--save_dir", "run", "--data_dir", root, "--batch_size", "2", "--num_steps", "1",
                "--save_interval", "1", "--log_interval", "1", *tiny])
    generate.main(["--model_path", "run/ckpt_000000001", "--num_samples", "1", "--num_repetitions",
                   "1", "--motion_length", "0.5", "--output_dir", "gen", "--device", "cpu"])
    edit.main(["--model_path", "run/ckpt_000000001", "--data_dir", root, "--num_samples", "1",
               "--output_dir", "edit", "--device", "cpu"])
    for out, frames in (("gen", 10), ("edit", 196)):
        res = np.load(os.path.join(out, "results.npy"), allow_pickle=True).item()
        assert res["motion"].shape == (1, frames, 22, 3) and np.isfinite(res["motion"]).all()
    from mdm_tpu_torch.cli import eval_humanml, train_evaluators
    from mdm_tpu_torch.scripts.quality_rehearsal import write_glove
    write_glove(tmp, ["a", "person", "walk"])
    ev = ["--data_dir", root, "--glove_dir", os.path.join(tmp, "glove"), "--num_steps", "1",
          "--batch_size", "2", "--movement_dim", "8", "--coemb_dim", "8", "--device", "cpu"]
    train_evaluators.main(["--stage", "decomp", "--save_path", "decomp.npy", *ev])
    os.makedirs("t2m/text_mot_match/model")
    train_evaluators.main(["--stage", "match", "--save_path", "t2m/text_mot_match/model/finest.npy",
                           "--decomp_path", "decomp.npy", *ev])
    train_evaluators.main(["--stage", "comp_v6", "--save_path", "comp_v6.npy", "--decomp_path",
                           "decomp.npy", "--schedule_start", "2", "--schedule_end", "2",
                           "--max_sub_epoch", "1", "--max_batches", "1", *ev])
    from mdm_tpu_torch.eval.t2m_generator import load_comp_v6
    assert load_comp_v6("comp_v6.npy")["mov_enc"]["out_net"]["kernel"].shape == (8, 8)
    summary = eval_humanml.main(["--model_path", "run", "--data_dir", root, "--eval_mode", "debug",
                                 "--replications", "1", "--evaluator_dir", ".", "--device", "cpu"])
    assert summary["comparable"] and np.isfinite(summary["FID"]["vald"]["mean"])
    from mdm_tpu_torch.cli import eval_a2m
    from mdm_tpu_torch.scripts.a2m_rehearsal import build_dataset, write_synthetic_smpl
    act = build_dataset(tmp, 12)
    write_synthetic_smpl(tmp, vertices=32, faces=4)
    a2m = ["--dataset", "humanact12", "--data_dir", act, "--num_frames", "60", "--batch_size", "2",
           "--latent_dim", "32", "--layers", "1", "--diffusion_steps", "4", "--device", "cpu"]
    train.main(["--save_dir", "a2m", "--num_steps", "1", "--save_interval", "1",
                "--lambda_rcxyz", "1", *a2m])
    train_evaluators.main(["--stage", "a2m_classifier", "--save_path", "clf.npy",
                           "--num_steps", "1", *a2m[:4], "--batch_size", "2", "--device", "cpu"])
    summary = eval_a2m.main(["--model_path", "a2m", "--data_dir", act, "--eval_mode", "debug",
                             "--replications", "1", "--a2m_classifier_path", "clf.npy",
                             "--device", "cpu"])
    assert summary["classifier"] == "self-trained" and np.isfinite(summary["fid_gen"]["mean"])
    import gzip
    from mdm_tpu_torch.cli import convert_checkpoint, convert_text_encoders
    from mdm_tpu_torch.models.text_encoders import ClipTextEncoder, ClipTextConfig
    from mdm_tpu_torch.sampling import text
    clip = ClipTextEncoder(ClipTextConfig(vocab_size=520, width=64, layers=1))
    torch.save(clip.state_dict(), "clip.pt")  # the OpenAI names
    r = lambda *s: torch.randn(*s) * 0.1
    bert = {"embeddings.word_embeddings.weight": r(20, 64),
            "embeddings.position_embeddings.weight": r(64, 64),
            "embeddings.LayerNorm.weight": r(64) + 1, "embeddings.LayerNorm.bias": r(64)}
    for n, (o, i) in {"attention.q_lin": (64, 64), "attention.k_lin": (64, 64),
                      "attention.v_lin": (64, 64), "attention.out_lin": (64, 64),
                      "ffn.lin1": (128, 64), "ffn.lin2": (64, 128), "sa_layer_norm": (64, 0),
                      "output_layer_norm": (64, 0)}.items():
        bert[f"transformer.layer.0.{n}.weight"] = r(o, i) if i else r(o) + 1
        bert[f"transformer.layer.0.{n}.bias"] = r(o)
    torch.save(bert, "bert.bin")
    convert_text_encoders.main(["--clip", "clip.pt", "--bert", "bert.bin", "--out_dir", "assets"])
    with gzip.open("assets/bpe_simple_vocab_16e6.txt.gz", "wt") as f:
        f.write("#version\nw a\nwa l\nwal k</w>")
    with open("assets/bert_vocab.txt", "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "walk"]))
    embeds = text.make_text_embedder("bert", "assets", device="cpu")(["a walk", "walk"])
    assert embeds["text_embed"].shape == (2, 64, 64) and embeds["text_tokens_mask"].sum() == 7
    text.DEFAULT_ASSETS = os.path.abspath("assets")
    sd = torch.load("run/ckpt_000000001", weights_only=True)["model"]
    os.makedirs("ref")
    torch.save({"model": sd}, "ref/model000000001.pt")
    path = convert_checkpoint.main(["--torch_ckpt", "ref/model000000001.pt", "--out_dir", "conv",
                                    "--latent_dim", "32", "--layers", "1"])
    generate.main(["--model_path", path, "--text_prompt", "a walk", "--num_samples", "1",
                   "--num_repetitions", "1", "--motion_length", "0.5", "--output_dir", "gen2",
                   "--device", "cpu", "--diffusion_steps", "4"])
    res = np.load("gen2/results.npy", allow_pickle=True).item()
    assert res["motion"].shape == (1, 10, 22, 3) and np.isfinite(res["motion"]).all()
    os.chdir(cwd)
assert not any(m.split(".")[0] in ("jax", "flax", "optax", "orbax", "mdm_tpu")
               for m, mod in sys.modules.items() if mod is not None)
print(" ".join(names))
"""

# The counterparts of the sampling, training, attention-route, command-line, evaluation,
# action-to-motion, published-weights and T2M-baseline-training slices' mdm_tpu modules.
SLICE = {"ops._mask", "ops.layer_inference", "ops._build", "models.layers", "models.mdm",
         "models.bridge", "diffusion.schedule", "diffusion.gaussian", "diffusion.samplers",
         "core.quaternions", "core.hml_codec", "sampling.text", "sampling.pipeline", "serving",
         "ops._chain", "ops.dropout_bits", "ops.attention_train_block", "ops.encoder_tail",
         "diffusion.losses", "train.resample", "train.state", "train.train_step",
         "train.checkpoints", "train.logger", "train.platforms", "train.loop",
         "ops.attention", "ops.attention_v2", "ops.attention_dropout", "ops.attention_block",
         "scripts.bench_sample_kernels", "scripts.bench_train_kernels",
         "scripts.attention_forward_probe", "core.hml_masks", "scripts.dip_probe",
         "core.rotations", "core.skeleton", "data", "data.collate", "data.word_vectorizer",
         "data.raw_text", "data.tokenizers", "data.get_opt", "data.humanml", "data.a2m",
         "data.loader", "utils", "utils.misc", "utils.parser", "utils.factory",
         "train.profiling", "visualize", "visualize.plot_script", "cli", "cli.train",
         "cli.generate", "cli.edit", "eval", "eval.metrics", "eval.networks", "eval.evaluator",
         "eval.train_evaluators", "eval.harness", "eval.t2m_generator", "cli.eval_humanml",
         "cli.train_evaluators", "scripts.quality_rehearsal", "smpl", "smpl.lbs", "smpl.rot2xyz",
         "eval.classifiers", "eval.stgcn", "eval.harness_a2m", "eval.a2m_setup", "cli.eval_a2m",
         "cli.eval_unconstrained", "scripts.a2m_rehearsal", "models.text_encoders",
         "models.convert", "cli.convert_text_encoders", "cli.convert_checkpoint",
         "visualize.prior", "visualize.joints2smpl", "cli.render_mesh",
         "eval.train_t2m_generator", "utils.compile_cache", "utils.tracing"}


def test_port_runs_with_jax_and_flax_blocked():
    res = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert {f"mdm_tpu_torch.{m}" for m in SLICE} <= set(res.stdout.split())


def test_no_source_file_names_jax():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                assert not {"jax", "flax", "optax", "orbax", "mdm_tpu"} & {w.split(".")[0]
                                                                  for w in words[1:2]}, \
                    f"{path.relative_to(REPO)}: {line}"
