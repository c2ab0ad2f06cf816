"""PyTorch port: the Audio Spectrogram Transformer backbone (``models/ast.py``)
against the plain reference ``benchmark/reference/ast.py``, on the CPU.

The AST group is cut to 2 layers of width 64, 4 heads and an MLP of 256,
on 32x64 maps with patch 16 at strides 10: 2 x 5 patches and the two
prepended tokens, 12 tokens a map. The experiment is
``configs_port/esc50_ast_cpl.json`` (5-way 5-shot 5-query, SpecAugment's 4
views, attention fusion, CPL) on the CPU.

Tolerances. The port and the reference compute in float32 in other orders
(a fused attention against the written-out softmax, F.layer_norm against
its formula, the K2 head's closed-form backward against autograd): observed
worst cases in brackets. Features within 1e-5 of their largest |value|
[3.0e-7]; each gradient within 1e-4 of that tensor's largest |g| or of the
median leaf's, whichever is larger [backbone alone 5.8e-7, whole step
2.1e-6]: a leaf whose gradient cancels is held at the median leaf's scale,
as the benchmark's check holds it (the fusion's last LayerNorm bias shifts
every feature alike, which leaves the distances unchanged: its gradient is
1e-3 of the median leaf's, and rounding is 6.6e-4 of it); the loss within
1e-5 relative [1.2e-7]; scores within 1e-5 of the largest |score|. The
port in bfloat16, the configuration's precision, reads 7.3e-3 on the
features and 1.7e-2 on the worst gradient
(``test_bfloat16_features_fail_the_tolerance``), so both tolerances are
tight enough that bf16 fails them.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch.data.store import PackedStore
from audio_few_shot_learning_tpu_torch.models import ast as port_ast
from audio_few_shot_learning_tpu_torch.models.encoders import make_backbone
from audio_few_shot_learning_tpu_torch.train import engine
from audio_few_shot_learning_tpu_torch.train.weights import to_jax_variables
from audio_few_shot_learning_tpu_torch.utils.profiling import read_counter
from benchmark import program
from benchmark.reference import ast as ref_ast
from benchmark.reference import model as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(ROOT, "configs_port")
AST_SMALL = {"embed_dim": 64, "depth": 2, "num_heads": 4, "mlp_dim": 256, "patch": 16, "fstride": 10, "tstride": 10,
             "out_dim": 16, "ln_eps": 1e-6}
MODEL = {"AST": AST_SMALL, "Attention": {"embed_dim": 16, "num_heads": 1, "ffn_dim": 32, "dropout": 0.1},
         "Projection": {"input_dim": 64, "hidden_dim": 32, "output_dim": 64}}
FEAT = (32, 64)
VIEWS, N_WAY = 4, 5
FEATURE_TOL, GRAD_TOL, LOSS_TOL, SCORE_TOL = 1e-5, 1e-4, 1e-5, 1e-5


def experiment(compute_dtype="float32", **tpu):
    with open(os.path.join(CONFIG_DIR, "esc50_ast_cpl.json")) as f:
        d = json.load(f)
    return {**d, "device": "cpu", "tpu": {"compute_dtype": compute_dtype, **tpu}}


def weights(seed=3):
    return ref.make_weights(ref_ast.param_specs(MODEL, FEAT, VIEWS), seed, "cpu")


def trainer(compute_dtype="float32", seed=3, **tpu):
    g = torch.Generator().manual_seed(seed)
    segments = torch.randn(8 * 12, *FEAT, generator=g)
    store = PackedStore.from_flat_arrays(segments, np.ones(96, np.int64), np.repeat(np.arange(8), 12), 8, device="cpu")
    exp = tcfg.ExperimentConfig.from_dict(experiment(compute_dtype, **tpu))
    t = engine.Trainer(exp, tcfg.ModelConfig.from_dict(MODEL), store, val_store=store, test_store=store, seed=0,
                       device="cpu")
    t.model.load_state_dict(weights(seed), strict=True)
    return t, store


def rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def encoder_errors(compute_dtype):
    """The backbone's features and every parameter's gradient (of a seeded
    projection of the features) against the reference's: the worst errors
    over their tensors' largest values."""
    t, _ = trainer(compute_dtype)
    enc = t.model.backbone.encoder
    x = torch.randn(6, *FEAT, generator=torch.Generator().manual_seed(5))
    r = torch.randn(6, AST_SMALL["out_dim"], generator=torch.Generator().manual_seed(6))
    enc.train()
    out = enc(x)
    (out * r).sum().backward()
    w = {k: v.detach().requires_grad_(True) for k, v in weights().items() if k.startswith("backbone.")}
    ref_out = ref_ast.encode(x, w, MODEL)
    (ref_out * r).sum().backward()
    grads = {name: rel(p.grad, w[f"backbone.encoder.{name}"].grad) for name, p in enc.named_parameters()}
    return rel(out.detach(), ref_out.detach()), grads


def test_backbone_matches_the_reference():
    feat_err, grads = encoder_errors("float32")
    assert feat_err <= FEATURE_TOL
    # every tensor of the reference's but the fusion layer's 12 and the projection's 8
    assert len(grads) == len(ref_ast.param_specs(MODEL, FEAT, VIEWS)) - 20
    worst = max(grads, key=grads.get)
    assert grads[worst] <= GRAD_TOL, (worst, grads[worst])


def test_bfloat16_features_fail_the_tolerance():
    feat_err, grads = encoder_errors("bfloat16")
    assert feat_err > FEATURE_TOL and max(grads.values()) > GRAD_TOL


def test_train_step_matches_the_reference():
    """One ``Trainer.train_step`` on the port's own episode and draws
    (``benchmark/program.py::train_feed``: its sampler, views, shuffle and
    Gumbel draws), dropout from a seeded ``Trainer.gen``, against
    ``reference/ast.py::train_steps`` on the same rows and draws: the loss
    and every leaf's gradient."""
    t, store = trainer()
    t.gen = torch.Generator().manual_seed(11)
    ep, draws = program.train_feed(t, store, torch.Generator().manual_seed(12), 1)
    metrics = t.train_step(ep, draws)
    episode = dict(support=ep.support, query=ep.query, support_labels=ep.support_labels,
                   query_labels=ep.query_labels, sup_draws=draws.support, qry_draws=draws.query,
                   perms=draws.perms, gumbel=draws.cpl_gumbel)
    exp = experiment()
    r = ref_ast.train_steps([episode], weights(), exp, MODEL, 11, t.steps_per_epoch, chunk=64)
    assert abs(float(metrics[0]) - r["losses"][0]) <= LOSS_TOL * abs(r["losses"][0])
    got = {k: p.grad for k, p in t.model.named_parameters() if p.grad is not None}
    assert set(got) == set(r["first_grads"])  # every leaf but the projection's unused LayerNorms
    scale = float(np.median([float(g.abs().max()) for g in r["first_grads"].values()]))
    errs = {k: float((got[k] - g).abs().max()) / max(float(g.abs().max()), scale)
            for k, g in r["first_grads"].items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    assert read_counter(port_ast.TOKENS) == 200 * 12  # 5 x (5 + 5) items x 4 views, 12 tokens each


def test_eval_and_predict_scores_match_the_reference():
    """``_episode_scores`` (what ``_eval_episodes`` takes the argmax of) and
    ``predict_episode`` on the port's draws, against
    ``reference/ast.py::eval_scores`` on the same rows and draws."""
    t, store = trainer()
    gen = torch.Generator().manual_seed(21)
    ep, (sd, qd) = program.eval_feed(t, store, gen, 2, N_WAY, 5, 5, True, False)
    with torch.inference_mode():
        scores = t._episode_scores(ep, N_WAY, True, gen, (sd, qd))
        acc = t._eval_episodes(ep, N_WAY, True, draws=(sd, qd))
    mv = float(experiment()["specaug_params"]["mask_value"])
    sv, qv = ref.views(ep.support, *sd, mv), ref.views(ep.query, *qd, mv)
    want = ref_ast.eval_scores(sv, qv, ep.support_labels, N_WAY, weights(), MODEL)
    assert rel(scores, want) <= SCORE_TOL
    assert torch.equal(acc, (want.argmax(-1) == ep.query_labels).float().mean(-1))
    one = lambda d: tuple(x[:1] for x in d)  # noqa: E731  (the first episode's draws)
    _, pscores = t.predict_episode(ep.support[0].numpy(), ep.support_labels[0].numpy(), ep.query[0].numpy(),
                                   n_way=N_WAY, draws=(one(sd), one(qd)))
    assert rel(torch.from_numpy(pscores), want[0]) <= SCORE_TOL


def test_remat_gives_the_same_step():
    """``tpu.remat`` recomputes each block in the backward pass: the same
    gradients as holding the activations."""
    grads = []
    for remat in (False, True):
        t, store = trainer(remat=remat)
        t.gen = torch.Generator().manual_seed(11)
        t.train_step(*program.train_feed(t, store, torch.Generator().manual_seed(12), 1))
        grads.append({k: p.grad for k, p in t.model.named_parameters() if p.grad is not None})
    assert all(torch.allclose(grads[0][k], grads[1][k], rtol=0, atol=1e-6) for k in grads[0])


def test_make_backbone_parses_the_ast_group():
    mdl = tcfg.ModelConfig.from_dict(MODEL)
    assert mdl.ast == tcfg.ASTConfig(**AST_SMALL)
    enc = make_backbone("AST", mdl.cnn, mdl.hybrid, FEAT, compute_dtype="float32", ast_cfg=mdl.ast).encoder
    assert len(enc.v.blocks) == 2 and enc.tokens == 12 and enc.out_dim == 16
    blk = enc.v.blocks[0]
    assert blk.attn.num_heads == 4 and blk.attn.qkv.weight.shape == (192, 64) and blk.mlp.fc1.weight.shape == (256, 64)
    assert blk.norm1.eps == 1e-6 and enc.mlp_head[0].eps == 1e-5
    assert enc.v.patch_embed.proj.stride == (10, 10) and enc.v.pos_embed.shape == (1, 12, 64)
    with open(os.path.join(CONFIG_DIR, "model_config_esc50_ast.json")) as f:
        published = tcfg.ModelConfig.from_dict(json.load(f)).ast
    assert published == tcfg.ASTConfig()  # the shipped file holds AST's published widths
    assert port_ast.patch_grid(published, (128, 512)) == (12, 50)  # 602 tokens a map


@pytest.mark.parametrize("name,group", [("Hybrid", "hybrid"), ("CNN", "cnn")])
def test_eval_rule_reckons_todays_bytes_for_the_conv_encoders(name, group):
    """Block 0's conv output, ``channels x F x T`` in the compute dtype, as
    the rule reckoned before the encoders named their own bytes."""
    mdl = tcfg.ModelConfig()
    enc = make_backbone(name, mdl.cnn, mdl.hybrid, (128, 157), compute_dtype="bfloat16").encoder
    assert enc.eval_item_bytes == getattr(mdl, group).hidden_channels * 128 * 157 * 2 == 2_572_288


def test_eval_rule_reckons_a_blocks_working_set_for_ast():
    """What one map holds at an AST eval forward's widest point: the
    residual stream, a LayerNorm output and the MLP hidden, in bf16."""
    t, store = trainer("bfloat16")
    assert t.model.backbone.encoder.eval_item_bytes == 12 * (2 * 64 + 256) * 2
    per_episode = (25 * 4 + 25 * 4) * 12 * (2 * 64 + 256) * 2  # 5-way 5-shot 5-query, 4 views each, s_max 1
    assert t.episode_bytes(store, N_WAY, 5, 5, True) == per_episode
    full = tcfg.ASTConfig()
    tokens = int(np.prod(port_ast.patch_grid(full, (128, 512)))) + 2
    assert tokens * (2 * full.embed_dim + full.mlp_dim) * 2 == 5_548_032


def test_conversion_to_the_jax_package_refuses_ast(tmp_path):
    from audio_few_shot_learning_tpu_torch.cli import convert_checkpoint

    t, _ = trainer()
    with pytest.raises(ValueError, match="AST"):
        to_jax_variables(t.model.state_dict(), t.exp)
    exp_path, model_path = tmp_path / "e.json", tmp_path / "m.json"
    exp_path.write_text(json.dumps(experiment()))
    model_path.write_text(json.dumps(MODEL))
    torch.save(t.model.state_dict(), tmp_path / "model.ckpt")
    with pytest.raises(ValueError, match="AST"):
        convert_checkpoint.main(["-e", str(exp_path), "-m", str(model_path), "--input", str(tmp_path / "model.ckpt"),
                                 "--output", str(tmp_path / "out.ckpt"), "--feat-shape", "32", "64"])
    assert not (tmp_path / "out.ckpt").exists()


def test_engine_paths_run():
    """``train_epoch``, ``validate``, single- and multi-segment ``test()``
    on an AST model, on the CPU: finite metrics and accuracies in [0, 1]."""
    t, store = trainer(eval_episode_batch=2)
    t.exp = dataclasses.replace(t.exp, n_training_tasks=2, n_testing_tasks=3)
    t.steps_per_epoch = 2
    out = t.train_epoch()
    assert np.isfinite([out["loss"], out["fsl_loss"], out["cpl_loss"]]).all()
    for result in (t.validate(), tuple(t.test().values())):
        assert 0.0 <= result[0] <= 1.0
    t.exp = dataclasses.replace(t.exp, multi_segm=True)
    assert 0.0 <= t.test()["mean_accuracy"] <= 1.0

