"""Checkpoint export, snapshots and the training front ends of the port, on
the CPU in fp32 (TINY config): single-file and sharded released-format
round trips through the port's loader; the same files read by the JAX
package's ``load_bagel_checkpoint`` give the JAX tree of the same weights;
adapters merged on export and a quantized model refused; a snapshot resume
equal to an uninterrupted run (optimizer moments, step, EMA and the latent
batch-norm's statistics restored); one short run of each front end
(``export_checkpoint``, ``make_synthetic_ckpt``, ``toy_overfit``).

Tolerances: round trips in fp32 are exact (``torch.equal``); the merged
adapter against ``merge_lora`` 1e-6 (the same fp32 product, rounded once);
the resumed run equals the uninterrupted one bit for bit (one process, the
same CPU kernels in the same order).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from unimedvl_tpu.weights import bagel_loader as jloader
from unimedvl_tpu_torch import quant
from unimedvl_tpu_torch.config import BagelConfig, E2EVAEConfig
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.scripts import export_checkpoint, make_synthetic_ckpt, toy_overfit
from unimedvl_tpu_torch.training import lora, trainer
from unimedvl_tpu_torch.weights import bagel_export, loader
from unimedvl_tpu_torch.weights.snapshot import restore_snapshot, save_snapshot

from tests.test_torch_config import port_config
from tests.test_torch_train import CFG, jax_state_dict, make_batch

PORT_CFG = port_config(CFG)


def tiny_model(cfg=PORT_CFG, seed=0, with_vae=True):
    model = bagel.Bagel(cfg, device="meta", dtype=torch.float32, with_vae=with_vae)
    model = model.to_empty(device="cpu")
    return bagel.init_random_(model, torch.Generator().manual_seed(seed), llm2vae_zero=False)


def _equal_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.fixture(scope="module")
def model():
    return tiny_model()


class TestExport:
    @pytest.mark.parametrize("shard_gb", [4.0, 2e-4])
    def test_round_trip_through_both_loaders(self, model, tmp_path, shard_gb):
        written = bagel_export.export_bagel_checkpoint(str(tmp_path), model, dtype=torch.float32,
                                                       shard_gb=shard_gb)
        shards = [n for n, kind in written.items() if kind == "weights" and n.startswith("ema")]
        assert ("model.safetensors.index.json" in written) == (len(shards) > 1)
        assert len(shards) == (1 if shard_gb > 1 else len(shards)) and "ae.safetensors" in written
        with open(tmp_path / "vit_config.json") as f:
            assert json.load(f)["num_hidden_layers"] == CFG.vit.num_hidden_layers + 1
        _equal_state(loader.load_bagel_checkpoint(str(tmp_path), cfg=PORT_CFG, device="cpu",
                                                  dtype=torch.float32), model)
        # the JAX package reads the same files into the JAX tree of the same weights
        jtree = jloader.load_bagel_checkpoint(str(tmp_path), cfg=CFG, dtype=np.float32)
        got = jax_state_dict(jtree)
        want = {k: v.numpy() for k, v in model.state_dict().items()}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k], np.float32), want[k], err_msg=k)

    def test_adapters_merged_and_quantized_refused(self, tmp_path):
        adapted = tiny_model()
        lora.add_lora(adapted, torch.Generator().manual_seed(1), rank=4, dtype=torch.float32)
        with torch.no_grad():
            for m in adapted.modules():
                if isinstance(m, lora.LoRALinear):
                    m.lora_b.normal_(0, 0.1, generator=torch.Generator().manual_seed(2))
        bagel_export.export_bagel_checkpoint(str(tmp_path / "a"), adapted, dtype=torch.float32)
        assert lora.has_lora(adapted)  # the model is left as it was
        got = loader.load_bagel_checkpoint(str(tmp_path / "a"), cfg=PORT_CFG, device="cpu",
                                           dtype=torch.float32)
        want = lora.merge_lora(adapted).state_dict()
        for k, v in got.state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=1e-6, atol=1e-6)
        quant.quantize_llm_params(adapted.language_model)
        with pytest.raises(ValueError, match="quantized"):
            bagel_export.export_bagel_checkpoint(str(tmp_path / "q"), adapted)

    def test_ema_override(self, model, tmp_path):
        name = "language_model.model.norm.weight"
        ema = {name: torch.full_like(model.state_dict()[name], 0.5)}
        bagel_export.export_bagel_checkpoint(str(tmp_path), model, dtype=torch.float32,
                                             overrides=ema)
        got = loader.load_bagel_checkpoint(str(tmp_path), cfg=PORT_CFG, device="cpu",
                                           dtype=torch.float32)
        assert torch.equal(got.state_dict()[name], ema[name])


E2E = dataclasses.replace(PORT_CFG, e2e=E2EVAEConfig(enable_batch_norm=True,
                                                     teacher_feature_dim=8,
                                                     diffusion_feature_layer=0))


def _e2e_batches():
    out = []
    for seed in range(3):
        b = make_batch()
        nv = b["vae_clean_tokens"].shape[0]
        b["repa_teacher_features"] = np.random.default_rng(seed).standard_normal(
            (nv, 8)).astype(np.float32)
        out.append([bagel.prepare_sequence(b, "cpu")])
    return out


class TestSnapshot:
    def _fresh(self):
        model = tiny_model(E2E)
        step, init_state = trainer.make_train_step(
            E2E, model, optimizer=trainer.make_optimizer(learning_rate=1e-3), ema_decay=0.9)
        return step, init_state()

    def test_resume_equals_an_uninterrupted_run(self, tmp_path):
        batches = _e2e_batches()

        def run(state, step, i):
            return step(state, batches[i], generator=torch.Generator().manual_seed(10 + i))

        step, straight = self._fresh()
        losses = []
        for i in range(3):
            straight, loss = run(straight, step, i)
            losses.append(float(loss))
        step, first = self._fresh()
        for i in range(2):
            first, _ = run(first, step, i)
        save_snapshot(str(tmp_path), first)
        step, resumed = self._fresh()
        resumed = restore_snapshot(str(tmp_path), resumed, device="cpu")
        assert resumed.step == 2 and torch.equal(resumed.bn_state.mean, first.bn_state.mean)
        resumed, loss = run(resumed, step, 2)
        assert float(loss) == losses[2] and resumed.step == straight.step == 3
        _equal_state(resumed.model, straight.model)
        for name, e in straight.ema_params.items():
            assert torch.equal(resumed.ema_params[name], e), name
        assert torch.equal(resumed.bn_state.var, straight.bn_state.var)
        assert not torch.equal(straight.bn_state.var, torch.ones(4))

    def test_module_snapshot_and_payload(self, model, tmp_path, monkeypatch):
        save_snapshot(str(tmp_path), model)
        other = tiny_model(seed=5)
        _equal_state(restore_snapshot(str(tmp_path), other, device="cpu"), model)
        assert restore_snapshot(str(tmp_path), device="cpu")["kind"] == "module"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):  # the card by default
            restore_snapshot(str(tmp_path))


FRONT_CFG = BagelConfig(llm=PORT_CFG.llm, vit=PORT_CFG.vit)  # the loader's defaults elsewhere


class TestFrontEnds:
    def test_export_checkpoint_from_ckpt_and_snapshot(self, tmp_path):
        src = tmp_path / "src"
        base = tiny_model(FRONT_CFG, with_vae=False)
        bagel_export.export_bagel_checkpoint(str(src), base, dtype=torch.float32)
        assert export_checkpoint.main([str(tmp_path / "a"), "--from-ckpt", str(src),
                                       "--device", "cpu"]) == 0
        _equal_state(loader.load_bagel_checkpoint(str(tmp_path / "a"), device="cpu"),
                     loader.load_bagel_checkpoint(str(src), device="cpu"))
        step, init_state = trainer.make_train_step(FRONT_CFG, base, ema_decay=0.5)
        state = init_state()
        state, _ = step(state, [bagel.prepare_sequence(make_batch(with_vae=False), "cpu")],
                        generator=torch.Generator().manual_seed(0))
        save_snapshot(str(tmp_path / "snap"), state)
        assert export_checkpoint.main([str(tmp_path / "b"), "--from-snapshot",
                                       str(tmp_path / "snap"), "--ckpt-config", str(src),
                                       "--device", "cpu"]) == 0
        got = loader.load_bagel_checkpoint(str(tmp_path / "b"), device="cpu",
                                           dtype=torch.float32).state_dict()
        for name, e in state.ema_params.items():
            # the EMA shadow was written, in the released dtype (bf16)
            assert torch.equal(got[name], e.to(torch.bfloat16).float()), name

    def test_make_synthetic_ckpt(self, tmp_path):
        cfg_dir = tmp_path / "cfg"
        bagel_export.export_bagel_checkpoint(str(cfg_dir), tiny_model(FRONT_CFG, with_vae=False))
        out = tmp_path / "out"
        assert make_synthetic_ckpt.main([str(out), "--config-dir", str(cfg_dir), "--layers", "1",
                                         "--no-vae", "--device", "cpu",
                                         "--shard-gb", "0.0002"]) == 0
        assert (out / "model.safetensors.index.json").exists()
        assert (out / "tokenizer.json").exists() and not (out / "ae.safetensors").exists()
        model = loader.load_bagel_checkpoint(str(out), device="cpu")
        assert model.config.llm.num_hidden_layers == 1
        assert all(torch.isfinite(p).all() for p in model.parameters())

    def test_toy_overfit(self, tmp_path):
        out = tmp_path / "curve.json"
        rc = toy_overfit.main(["--out", str(out), "--steps", "25", "--device", "cpu",
                               "--ema-decay", "0.9", "--export-dir", str(tmp_path / "exp")])
        res = json.loads(out.read_text())
        assert rc == 0 and len(res["curve"]) == 25 and res["export_kind"] == "ema"
        assert res["loss_last10_mean"] < res["loss_first10_mean"]
        assert os.path.exists(tmp_path / "exp" / "ema.safetensors")
