"""mdm_tpu_torch's command-line path against mdm_tpu's, on the CPU: the
parser and the factory give the same args and configs, train -> generate
-> edit runs with --device cpu and writes mdm_tpu's args.json keys and
results.npy keys and shapes, a resumed run is bitwise the uninterrupted
one, the CLI refuses to fall back to the CPU, Predictor serves a CLI
checkpoint's EMA parameters, the text-encoder contract, and TrainLoop's
profiler window."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_cli import synthetic_humanact12, synthetic_humanml, synthetic_kit  # noqa: E402,F401

from mdm_tpu.sampling import text as jtext  # noqa: E402
from mdm_tpu.utils import factory as jfactory  # noqa: E402
from mdm_tpu.utils import parser as jparser  # noqa: E402
from mdm_tpu_torch.cli import edit as edit_cli  # noqa: E402
from mdm_tpu_torch.cli import generate as gen_cli  # noqa: E402
from mdm_tpu_torch.cli import train as train_cli  # noqa: E402
from mdm_tpu_torch.sampling import text  # noqa: E402
from mdm_tpu_torch.utils import factory, parser  # noqa: E402

@pytest.fixture(autouse=True)
def _cwd(tmp_path, monkeypatch):
    """Each test runs in its own directory: the dataset's parse cache goes
    under ./save there."""
    monkeypatch.chdir(tmp_path)


TINY = ["--batch_size", "4", "--latent_dim", "32", "--layers", "2", "--diffusion_steps", "8",
        "--log_interval", "1"]


def _train(save_dir, data_dir, *extra, device="cpu"):
    return train_cli.main(["--save_dir", save_dir, "--dataset", "humanml", "--data_dir", data_dir,
                           *TINY, *extra, "--device", device])


def _ckpts(run):
    return sorted(f for f in os.listdir(run) if f.startswith("ckpt_"))


ARGVS = {
    "trans_enc": [],
    "dip": ["--arch", "trans_dec", "--context_len", "20", "--pred_len", "40",
            "--text_encoder_type", "bert", "--mask_frames", "--emb_trans_dec", "true"],
    "gru": ["--dataset", "humanact12", "--arch", "gru", "--lambda_vel", "1.0"],
    "goal": ["--context_len", "20", "--lambda_target_loc", "1.0",
             "--multi_encoder_type", "split", "--compute_dtype", "bfloat16"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_parser_and_factory_match_jax(case):
    argv = ["--save_dir", "/nonexistent/run", *ARGVS[case]]
    ours, ref = parser.train_args(argv), jparser.train_args(argv)
    assert vars(ours) == vars(ref)
    for gen_argv in (["--model_path", "/nonexistent/ckpt_000000001", *ARGVS[case][:2]],
                     ["--model_path", "x", "--guidance_param", "3", "--sampler", "ddim"]):
        assert vars(parser.generate_args(gen_argv)) == vars(jparser.generate_args(gen_argv))
        assert vars(parser.edit_args(gen_argv)) == vars(jparser.edit_args(gen_argv))
    num_actions = 12 if ours.dataset == "humanact12" else 1
    assert (dataclasses.asdict(factory.get_model_config(ours, num_actions))
            == dataclasses.asdict(jfactory.get_model_config(ref, num_actions)))
    to_names = lambda c: {k: getattr(v, "name", v) for k, v in dataclasses.asdict(c).items()}
    assert to_names(factory.create_loss_config(ours)) == to_names(jfactory.create_loss_config(ref))
    sched, jsched = factory.create_schedule(ours, "10"), jfactory.create_schedule(ref, "10")
    np.testing.assert_array_equal(sched.betas.numpy(), np.asarray(jsched.betas))


def test_device_argument():
    assert parser.train_args(["--save_dir", "x", "--device", "cpu"]).device == "cpu"
    assert parser.train_args(["--save_dir", "x", "--device", "1"]).device == 1
    assert parser.select_device(parser.train_args(["--save_dir", "x", "--device", "cpu"])
                                ).type == "cpu"


def test_train_refuses_cpu_fallback(tmp_path, synthetic_humanml, monkeypatch):
    """--device 0 (the default) with no CUDA device raises, before any step
    runs on the CPU. A one-process world through MDM_TPU_COORDINATOR (gloo)
    trains two steps and writes the checkpoint of the run without it,
    bitwise."""
    import torch.distributed as dist

    from mdm_tpu_torch.parallel.multihost import find_free_port

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _train(str(tmp_path / "run"), synthetic_humanml, "--num_steps", "2", device="0")
    assert not (tmp_path / "run").exists()
    args = ("--num_steps", "2", "--save_interval", "2", "--use_ema", "true")
    _train(str(tmp_path / "alone"), synthetic_humanml, *args)
    monkeypatch.setenv("MDM_TPU_COORDINATOR", f"localhost:{find_free_port()}")
    monkeypatch.setenv("MDM_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("MDM_TPU_PROCESS_ID", "0")
    try:
        _train(str(tmp_path / "world"), synthetic_humanml, *args)
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"  # no CUDA device: the CPU world
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    load = lambda d: torch.load(os.path.join(d, "ckpt_000000002"), weights_only=True)
    a, w = load(tmp_path / "alone"), load(tmp_path / "world")
    assert a["step"] == w["step"] == 2
    for part in ("model", "ema_params"):
        for k in a[part]:
            assert torch.equal(a[part][k], w[part][k]), (part, k)
    for i, s in a["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s[k], w["optimizer"]["state"][i][k]), (i, k)


def test_train_refuses_unported_options(tmp_path, synthetic_humanml, synthetic_humanact12):
    """mdm_tpu's own refusals of the geometric losses: on HumanML3D the loss
    has no decoder (mdm_tpu/diffusion/losses.py: "geometric losses need a
    get_xyz decoder"); on HumanAct12 without body_models/smpl the SMPL load
    raises FileNotFoundError (mdm_tpu/smpl/lbs.py)."""
    with pytest.raises(ValueError, match="get_xyz decoder"):
        _train(str(tmp_path / "a"), synthetic_humanml, "--lambda_rcxyz", "1.0", "--num_steps", "1")
    with pytest.raises(FileNotFoundError, match="SMPL_NEUTRAL"):
        train_cli.main(["--save_dir", str(tmp_path / "b"), "--dataset", "humanact12",
                        "--data_dir", synthetic_humanact12, *TINY, "--num_steps", "1",
                        "--lambda_fc", "1.0", "--device", "cpu"])


def test_train_generate_edit_schema_matches_jax(tmp_path, synthetic_humanml, monkeypatch):
    """The CPU CLI path; args.json keys and results.npy keys/shapes as
    mdm_tpu's CLIs write them for the same flags."""
    from mdm_tpu.cli import edit as jedit_cli
    from mdm_tpu.cli import generate as jgen_cli
    from mdm_tpu.cli import train as jtrain_cli

    run = str(tmp_path / "run")
    loop = _train(run, synthetic_humanml, "--num_steps", "4", "--save_interval", "2",
                  "--use_ema", "true")
    assert loop.step == 4 and _ckpts(run) == ["ckpt_000000002", "ckpt_000000004"]
    jrun = str(tmp_path / "jrun")
    jtrain_cli.main(["--save_dir", jrun, "--dataset", "humanml", "--data_dir", synthetic_humanml,
                     *TINY, "--num_steps", "0", "--use_ema", "true"])
    with open(os.path.join(run, "args.json")) as f:
        ours = json.load(f)
    with open(os.path.join(jrun, "args.json")) as f:
        ref = json.load(f)
    assert ours.keys() == ref.keys()
    differ = ("save_dir", "device", "num_steps", "save_interval")  # as the argvs differ
    assert {k: v for k, v in ours.items() if k not in differ} == \
        {k: v for k, v in ref.items() if k not in differ}
    assert ours["text_encoder_type"] == "hash" and ours["device"] == "cpu"

    gen = ["--num_samples", "2", "--num_repetitions", "2", "--motion_length", "1.0", "--seed", "3"]
    gen_cli.main(["--model_path", os.path.join(run, "ckpt_000000004"),
                  "--output_dir", str(tmp_path / "g"), "--device", "cpu", *gen])
    jgen_cli.main(["--model_path", os.path.join(jrun, "ckpt_000000004"),  # absent: random weights
                   "--output_dir", str(tmp_path / "jg"), *gen])
    edit = ["--data_dir", synthetic_humanml, "--num_samples", "2", "--seed", "5",
            "--use_dataset_captions"]
    edit_cli.main(["--model_path", os.path.join(run, "ckpt_000000004"), "--output_dir",
                   str(tmp_path / "e"), "--device", "cpu", *edit])
    jedit_cli.main(["--model_path", os.path.join(jrun, "ckpt_000000004"),
                    "--output_dir", str(tmp_path / "je"), *edit])
    for a, b in (("g", "jg"), ("e", "je")):
        r = np.load(tmp_path / a / "results.npy", allow_pickle=True).item()
        j = np.load(tmp_path / b / "results.npy", allow_pickle=True).item()
        assert r.keys() == j.keys()
        for k in r:
            assert np.shape(r[k]) == np.shape(j[k]), k
        assert np.isfinite(r["motion"]).all()
    assert sorted(os.listdir(tmp_path / "g")) == sorted(os.listdir(tmp_path / "jg"))


def test_resume_is_bitwise(tmp_path, synthetic_humanml):
    """4 steps straight == 2 steps, then a second run resuming from the
    checkpoint for 2 more: parameters, EMA and AdamW state."""
    straight = str(tmp_path / "a")
    _train(straight, synthetic_humanml, "--num_steps", "4", "--save_interval", "2",
           "--use_ema", "true")
    half = str(tmp_path / "b")
    _train(half, synthetic_humanml, "--num_steps", "2", "--save_interval", "2",
           "--use_ema", "true")
    resumed = str(tmp_path / "c")
    _train(resumed, synthetic_humanml, "--num_steps", "4", "--save_interval", "2",
           "--use_ema", "true", "--resume_checkpoint", os.path.join(half, "ckpt_000000002"))
    load = lambda d: torch.load(os.path.join(d, "ckpt_000000004"), weights_only=True)
    a, c = load(straight), load(resumed)
    assert a["step"] == c["step"] == 4
    for k in a["model"]:
        assert torch.equal(a["model"][k], c["model"][k]), k
    for k in a["ema_params"]:
        assert torch.equal(a["ema_params"][k], c["ema_params"][k]), k
    for i, s in a["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s[k], c["optimizer"]["state"][i][k]), (i, k)


def test_predictor_serves_cli_checkpoint(tmp_path, synthetic_humanml):
    from mdm_tpu_torch.serving import Predictor, PredictorConfig

    run = str(tmp_path / "run")
    _train(run, synthetic_humanml, "--num_steps", "2", "--save_interval", "2", "--use_ema", "true",
           "--avg_model_beta", "0.5")
    sd = torch.load(os.path.join(run, "ckpt_000000002"), weights_only=True)
    for use_ema, want in ((True, sd["ema_params"]), (False, sd["model"])):
        p = Predictor(PredictorConfig(model_path=run, latent_dim=32, layers=2, max_frames=20,
                                      num_diffusion_steps=8, respacing="", use_ema=use_ema,
                                      compute_dtype="float32", device="cpu"))
        p.setup()
        got = dict(p.model.named_parameters())
        assert got.keys() == sd["ema_params"].keys()
        for name, t in got.items():
            assert torch.equal(t.detach(), want[name]), name
    assert not all(torch.equal(sd["ema_params"][k], sd["model"][k]) for k in sd["ema_params"])
    out = p.predict("a person walks", motion_length_sec=0.5, seed=1)
    assert np.asarray(out["joints"][0]).shape == (1, 10, 22, 3)


def test_generate_refuses_an_orbax_checkpoint(tmp_path, synthetic_humanml):
    run = tmp_path / "jax_run"
    (run / "ckpt_000000002").mkdir(parents=True)  # orbax writes a directory
    with open(run / "args.json", "w") as f:
        json.dump({"latent_dim": 32, "layers": 2, "diffusion_steps": 8,
                   "text_encoder_type": "hash"}, f)
    with pytest.raises(ValueError, match="orbax.*item 11"):
        gen_cli.main(["--model_path", str(run / "ckpt_000000002"), "--num_samples", "1",
                      "--num_repetitions", "1", "--motion_length", "0.5", "--device", "cpu",
                      "--output_dir", str(tmp_path / "out")])


def test_text_encoder_contract(tmp_path):
    """None exactly where mdm_tpu's make_text_embedder gives None (the
    CLIP/BERT assets absent); where only mdm_tpu's orbax weights are, a
    FileNotFoundError naming the port's converter (the towers themselves:
    tests/test_torch_text_encoders.py)."""
    for kind in ("clip", "bert"):
        assert text.make_text_embedder(kind, device="cpu") is None
        assert jtext.make_text_embedder(kind) is None
        assets = tmp_path / kind
        assets.mkdir()
        vocab, _, orbax = text.ASSETS[kind]
        (assets / vocab).write_bytes(b"")
        (assets / orbax).mkdir()
        with pytest.raises(FileNotFoundError, match="convert_text_encoders"):
            text.make_text_embedder(kind, str(assets), device="cpu")
    assert isinstance(text.make_text_embedder("hash"), text.HashTextEmbedder)
    with pytest.raises(ValueError):
        text.make_text_embedder("t5")


def test_profile_trace_dir_traces_steps_2_to_6(tmp_path, synthetic_humanml):
    """The trace of steps 2..6 holds the program's spans: five of each of
    ``train.step`` and ``train.batch``; a span opened under ``profiling.trace``
    is in its trace too."""
    from mdm_tpu_torch.train import profiling
    from mdm_tpu_torch.utils.tracing import span

    trace_dir = tmp_path / "trace"
    _train(str(tmp_path / "run"), synthetic_humanml, "--num_steps", "8", "--save_interval", "8",
           "--profile_trace_dir", str(trace_dir))
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("ProfilerStep" in e.get("name", "") or e.get("cat") == "cpu_op" for e in events)
    names = [e.get("name") for e in events if e.get("ph") == "X"]
    assert names.count("train.step") == 5 and names.count("train.batch") == 5
    with profiling.trace(str(tmp_path / "t2")):
        with span("region"):
            torch.ones(4).sum()
    traces = list((tmp_path / "t2").glob("*.pt.trace.json"))
    assert traces and any(e.get("name") == "region"
                          for e in json.loads(traces[0].read_text())["traceEvents"])


OPTIONS = {
    "goal": ["--lambda_target_loc", "1.0"],
    "loss_aware": ["--schedule_sampler", "loss-second-moment"],
    "cached_batches": ["--cache_batches", "2"],
    "dip": ["--arch", "trans_dec", "--context_len", "4", "--pred_len", "8"],
    "a2m": ["--dataset", "humanact12", "--num_frames", "60"],
    "unconstrained": ["--dataset", "humanact12", "--num_frames", "60", "--unconstrained",
                      "--cond_mask_prob", "0"],
}


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_train_cli_paths(tmp_path, synthetic_humanml, synthetic_humanact12, case):
    """The train CLI's other paths (tests/test_cli.py's JAX runs): goal
    conditioning, the loss-aware sampler, device-cached batches, DiP,
    action-to-motion and unconditioned training, 2 steps each."""
    argv = OPTIONS[case]
    data_dir = synthetic_humanact12 if "humanact12" in argv else synthetic_humanml
    run = str(tmp_path / "run")
    loop = train_cli.main(["--save_dir", run, "--data_dir", data_dir, *TINY, "--num_steps", "2",
                           "--save_interval", "2", *argv, "--device", "cpu"])
    assert loop.step == 2 and _ckpts(run) == ["ckpt_000000002"]
    with open(os.path.join(run, "progress.jsonl")) as f:
        assert all(np.isfinite(json.loads(line)["loss"]) for line in f if line.strip())
    with open(os.path.join(run, "args.json")) as f:
        assert json.load(f)["cond_mode"] == vars(parser.train_args(
            ["--save_dir", run, *argv]))["cond_mode"]


def test_gen_during_training_samples_the_ema(tmp_path, synthetic_humanml, monkeypatch):
    from mdm_tpu_torch.sampling import MotionGenerator

    seen = []
    generate = MotionGenerator.generate

    def spy(self, cond, B, T, generator=None, **kw):
        out = generate(self, cond, B, T, generator, **kw)
        seen.append((B, T, tuple(out["joints"].shape),
                     {n: p.detach().clone() for n, p in self.model.named_parameters()}))
        return out

    monkeypatch.setattr(MotionGenerator, "generate", spy)
    run = str(tmp_path / "run")
    _train(run, synthetic_humanml, "--num_steps", "2", "--save_interval", "2", "--use_ema", "true",
           "--avg_model_beta", "0.5", "--gen_during_training", "--gen_num_samples", "2",
           "--gen_num_repetitions", "1")
    ema = torch.load(os.path.join(run, "ckpt_000000002"), weights_only=True)["ema_params"]
    assert len(seen) == 1 and seen[0][:3] == (2, 196, (2, 196, 22, 3))
    for name, t in seen[0][3].items():
        assert torch.equal(t, ema[name]), name


# The evaluation protocol: train_evaluators -> train -> eval_humanml.
EV_TINY = ["--movement_dim", "16", "--coemb_dim", "16", "--num_steps", "2", "--batch_size", "4",
           "--log_every", "1", "--device", "cpu"]
EVAL_KEYS = {"Matching Score", "R_precision", "FID", "Diversity", "MultiModality", "comparable"}


def _evaluators(tmp_path, data_dir, dataset):
    """decomp -> match (finest.npy where EvaluatorWrapper resolves it) ->
    length, on the CPU at tiny widths, with a GloVe vocabulary beside the
    data (where eval_humanml looks for it)."""
    from test_torch_eval import _write_glove

    from mdm_tpu_torch.cli import train_evaluators as tev_cli

    glove = os.path.join(os.path.dirname(data_dir), "glove")
    os.makedirs(glove, exist_ok=True)
    _write_glove(glove)
    common = ["--dataset", dataset, "--data_dir", data_dir, "--glove_dir", glove, *EV_TINY]
    family = "t2m" if dataset == "humanml" else dataset
    finest = tmp_path / family / "text_mot_match" / "model" / "finest.npy"
    finest.parent.mkdir(parents=True)
    tev_cli.main(["--stage", "decomp", "--save_path", str(tmp_path / "decomp.npy"), *common])
    tev_cli.main(["--stage", "match", "--save_path", str(finest), "--decomp_path",
                  str(tmp_path / "decomp.npy"), *common])
    tev_cli.main(["--stage", "length", "--save_path", str(tmp_path / "length.npy"),
                  "--cache_batches", "1", *common])
    return str(finest)


def _eval(ckpt, data_dir, evaluator_dir, *extra, device="cpu"):
    from mdm_tpu_torch.cli import eval_humanml as eval_cli

    return eval_cli.main(["--model_path", ckpt, "--data_dir", data_dir, "--eval_mode", "debug",
                          "--replications", "2", "--evaluator_dir", evaluator_dir, *extra,
                          "--device", device])


def _comp_v6_npy(path):
    """A small Comp_v6 parameter tree at HumanML3D's 263 features, in
    mdm_tpu's comp_v6 .npy format (its save_comp_v6_params)."""
    import jax

    from mdm_tpu.eval import train_t2m_generator as jt2m

    cfg = jt2m.CompV6TrainConfig(dim_text_hidden=16, dim_att_vec=16, dim_z=8, dim_pri_hidden=16,
                                 dim_dec_hidden=16, dim_movement_latent=16,
                                 dim_movement_hidden=16)
    jt2m.save_comp_v6_params(path, jt2m.init_comp_v6_params(jax.random.PRNGKey(0), cfg))
    return path


@pytest.mark.parametrize("dataset", ["humanml", "kit"])
def test_train_evaluators_then_eval_humanml(tmp_path, synthetic_humanml, synthetic_kit, dataset):
    """The t2m protocol on the CPU: the three evaluator stages, a 2-step
    cli.train, cli.eval_humanml (debug, 2 replications) against the trained
    finest.npy — for KIT resolved under kit/ — writing mdm_tpu's
    eval_<ckpt>_<mode>_gscale<g>.log / .json; on humanml the T2M baseline
    (a comp_v6 .npy and the length stage's .npy) is scored beside MDM."""
    data_dir = synthetic_humanml if dataset == "humanml" else synthetic_kit
    _evaluators(tmp_path, data_dir, dataset)
    run = str(tmp_path / "run")
    train_cli.main(["--save_dir", run, "--dataset", dataset, "--data_dir", data_dir, *TINY,
                    "--num_steps", "2", "--save_interval", "2", "--device", "cpu"])
    extra = []
    if dataset == "humanml":
        extra = ["--t2m_baseline_path", _comp_v6_npy(str(tmp_path / "comp_v6.npy")),
                 "--t2m_len_est_path", str(tmp_path / "length.npy")]
    summary = _eval(run, data_dir, str(tmp_path), *extra)
    assert summary["comparable"] is True and "degraded_reasons" not in summary
    names = {"vald", "ground truth"} | ({"t2m_baseline"} if extra else set())
    for metric in ("Matching Score", "R_precision", "FID", "Diversity"):
        assert set(summary[metric]) == names
        assert all(np.isfinite(v["mean"]).all() for v in summary[metric].values())
    stem = os.path.join(run, "eval_ckpt_000000002_debug_gscale2.5")
    with open(stem + ".json") as f:
        assert set(json.load(f)) == EVAL_KEYS
    with open(stem + ".log") as f:
        assert f.read().count("Replication") == 2


def test_eval_humanml_autoregressive(tmp_path, synthetic_humanml):
    """DiP's protocol: a tiny trans_dec (context 4, pred 8) evaluated with
    --autoregressive, generated to each clip's original length."""
    from mdm_tpu_torch.sampling import MotionGenerator

    _evaluators(tmp_path, synthetic_humanml, "humanml")
    run = str(tmp_path / "run")
    _train(run, synthetic_humanml, "--num_steps", "2", "--save_interval", "2",
           "--arch", "trans_dec", "--context_len", "4", "--pred_len", "8", "--autoregressive")
    frames = []
    sample = MotionGenerator.sample_autoregressive

    def spy(self, cond, B, generator=None, required_frames=196, **kw):
        out = sample(self, cond, B, generator, required_frames, **kw)
        frames.append((required_frames, tuple(out.shape)))
        return out

    MotionGenerator.sample_autoregressive = spy
    try:
        summary = _eval(os.path.join(run, "ckpt_000000002"), synthetic_humanml, str(tmp_path),
                        "--autoregressive", "--guidance_param", "7.5")
    finally:
        MotionGenerator.sample_autoregressive = sample
    assert len(frames) == 2 and frames[0][1][:2] == (32, frames[0][0]) and frames[0][0] > 12
    assert np.isfinite(summary["FID"]["vald"]["mean"])
    assert os.path.exists(os.path.join(run, "eval_ckpt_000000002_debug_gscale7.5.json"))


def test_eval_during_training_runs_its_pass(tmp_path, synthetic_humanml, monkeypatch):
    """With a finest.npy under --evaluator_dir, cli.train evaluates at each
    save and reports the Eval group (from the EMA weights: the sampling copy
    holds them)."""
    from mdm_tpu_torch.train.platforms import NoPlatform

    _evaluators(tmp_path, synthetic_humanml, "humanml")
    reported = []
    monkeypatch.setattr(NoPlatform, "report_scalar",
                        lambda self, name, value, it, group_name="": reported.append(
                            (group_name, name, it, value)))
    run = str(tmp_path / "run")
    _train(run, synthetic_humanml, "--num_steps", "2", "--save_interval", "1", "--use_ema", "true",
           "--eval_during_training", "--evaluator_dir", str(tmp_path), "--eval_rep_times", "1")
    evals = {(name, it): v for group, name, it, v in reported if group == "Eval"}
    assert {it for _, it in evals} == {1, 2}
    assert {"FID_vald", "R_precision_vald", "Matching Score_ground truth"} <= {
        n for n, _ in evals}
    assert all(np.isfinite(v) for v in evals.values())


def test_eval_clis_refuse_cpu_fallback(tmp_path, synthetic_humanml, monkeypatch):
    from mdm_tpu_torch.cli import train_evaluators as tev_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tev_cli.main(["--stage", "decomp", "--data_dir", synthetic_humanml, "--save_path",
                      str(tmp_path / "d.npy"), "--num_steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _eval(str(tmp_path / "run"), synthetic_humanml, str(tmp_path), device="0")
    from mdm_tpu_torch.cli import eval_a2m, eval_unconstrained

    for cli in (eval_a2m, eval_unconstrained):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--model_path", str(tmp_path / "run"), "--dataset", "humanact12"])
    # every stage is ported: comp_v6 refuses the fallback too
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tev_cli.main(["--stage", "comp_v6", "--data_dir", synthetic_humanml, "--save_path",
                      str(tmp_path / "x.npy")])
    assert not hasattr(tev_cli, "NOT_PORTED")


# The action-to-motion protocols: train_evaluators -> train -> eval_a2m /
# eval_unconstrained, with --device cpu on test_cli.py's HumanAct12 tree.
A2M_TINY = [*TINY, "--num_frames", "60", "--device", "cpu"]
# mdm_tpu/cli/eval_a2m.py's JSON for the same flags: every metric of its
# harness for the gt / gt2 / gen passes (mdm_tpu/eval/harness_a2m.py), and
# the stamps.
A2M_KEYS = {f"{m}_{p}" for m in ("accuracy", "diversity", "multimodality", "fid")
            for p in ("gt", "gt2", "gen")} | {"comparable", "classifier"}
# mdm_tpu/cli/eval_unconstrained.py's.
UNCONSTRAINED_KEYS = {"fid", "kid", "kid_std", "precision", "recall", "diversity", "comparable",
                      "classifier"}


def _stage(stage, data_dir, save_path):
    from mdm_tpu_torch.cli import train_evaluators as tev_cli

    tev_cli.main(["--stage", stage, "--dataset", "humanact12", "--data_dir", data_dir,
                  "--save_path", save_path, "--num_steps", "2", "--batch_size", "4",
                  "--log_every", "1", "--device", "cpu"])
    return np.load(save_path, allow_pickle=True).item()


def test_a2m_protocol_cli(tmp_path, synthetic_humanact12, monkeypatch):
    """With a synthetic SMPL pickle in the working directory: the
    a2m_classifier stage (the GRU on SMPL xyz), a 2-step cli.train with the
    geometric losses and evaluation during training (the Eval group of
    mdm_tpu's test_train_a2m_eval_during_training), then cli.eval_a2m with the
    self-trained classifier and with the random-init one, stamped as
    mdm_tpu stamps them."""
    from mdm_tpu_torch.cli import eval_a2m
    from mdm_tpu_torch.scripts.a2m_rehearsal import write_synthetic_smpl
    from mdm_tpu_torch.train.platforms import NoPlatform

    write_synthetic_smpl(str(tmp_path), vertices=64, faces=8)
    blob = _stage("a2m_classifier", synthetic_humanact12, str(tmp_path / "clf.npy"))
    assert {k: blob[k] for k in ("feature", "arch", "input_size", "num_actions")} == \
        {"feature": "xyz", "arch": "gru", "input_size": 72, "num_actions": 12}
    reported = []
    monkeypatch.setattr(NoPlatform, "report_scalar",
                        lambda self, name, value, it, group_name="": reported.append(
                            (group_name, name, value)))
    run = str(tmp_path / "run")
    train_cli.main(["--save_dir", run, "--dataset", "humanact12", "--data_dir",
                    synthetic_humanact12, *A2M_TINY, "--num_steps", "2", "--save_interval", "2",
                    "--lambda_rcxyz", "1", "--lambda_vel", "1", "--lambda_fc", "1",
                    "--eval_during_training", "--eval_rep_times", "1", "--eval_num_samples", "4",
                    "--eval_batch_size", "4"])
    with open(os.path.join(run, "progress.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    assert all(np.isfinite(r[k]) for r in rows for k in ("rcxyz_mse", "vel_mse", "fc", "loss"))
    evals = {name: v for group, name, v in reported if group == "Eval"}
    assert {"accuracy_gen", "fid_gen", "fid_gt2", "diversity_gen", "eval_comparable"} <= set(evals)
    for path, stamp in ((str(tmp_path / "clf.npy"), "self-trained"), ("", "random-init")):
        summary = eval_a2m.main(["--model_path", run, "--data_dir", synthetic_humanact12,
                                 "--eval_mode", "debug", "--a2m_classifier_path", path,
                                 "--device", "cpu"])
        assert set(summary) == A2M_KEYS | ({"degraded_reasons"} if not path else set())
        assert summary["classifier"] == stamp and summary["comparable"] is False
        assert np.isfinite(summary["fid_gen"]["mean"]) and summary["accuracy_gt"]["mean"] >= 0
        with open(os.path.join(run, "eval_a2m_humanact12.json")) as f:
            assert json.load(f) == json.loads(json.dumps(summary))


def test_unconstrained_protocol_cli(tmp_path, synthetic_humanact12):
    """Without the SMPL asset: the unconstrained_stgcn stage on the pseudo
    joints, a 2-step unconditioned cli.train and cli.eval_unconstrained with
    the trained extractor, stamped no-smpl-asset as mdm_tpu's."""
    from mdm_tpu_torch.cli import eval_unconstrained

    blob = _stage("unconstrained_stgcn", synthetic_humanact12, str(tmp_path / "st.npy"))
    assert {k: blob[k] for k in ("feature", "arch", "layout", "in_channels")} == \
        {"feature": "pseudo", "arch": "stgcn_modi15", "layout": "openpose_modi15",
         "in_channels": 3}
    run = str(tmp_path / "run")
    train_cli.main(["--save_dir", run, "--dataset", "humanact12", "--unconstrained",
                    "--data_dir", synthetic_humanact12, *A2M_TINY, "--num_steps", "2",
                    "--save_interval", "2", "--cond_mask_prob", "0"])
    summary = eval_unconstrained.main(["--model_path", os.path.join(run, "ckpt_000000002"),
                                       "--data_dir", synthetic_humanact12, "--eval_mode", "debug",
                                       "--a2m_classifier_path", str(tmp_path / "st.npy"),
                                       "--device", "cpu"])
    assert set(summary) == UNCONSTRAINED_KEYS | {"degraded_reasons"}
    assert summary["degraded_reasons"] == ["no-smpl-asset"]
    assert summary["classifier"] == "self-trained" and summary["comparable"] is False
    assert all(np.isfinite(summary[k]) for k in ("fid", "kid", "precision", "recall"))
    assert os.path.exists(os.path.join(run, "eval_unconstrained.json"))
