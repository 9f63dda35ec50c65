"""Checkpoint/metrics/config/profiling/CLI tests (aux subsystems, SURVEY §5)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        from difffe_tpu.utils import CheckpointManager
        mgr = CheckpointManager(str(tmp_path / "ck"))
        state = {"params": [jnp.arange(5.0), jnp.ones((2, 3))],
                 "step": jnp.asarray(7),
                 "key": jax.random.PRNGKey(3)}
        mgr.save(7, state)
        assert mgr.latest_step() == 7
        restored = mgr.restore(7, template=state)
        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_async_save_restore_roundtrip(self, tmp_path):
        """AsyncCheckpointer path: save returns immediately, restore waits
        for the in-flight write to land (VERDICT round-1 weak #3)."""
        from difffe_tpu.utils import CheckpointManager
        mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True)
        state = {"w": jnp.linspace(0.0, 1.0, 16), "step": jnp.asarray(5)}
        mgr.save(5, state)
        restored = mgr.restore(5, template=state)   # implicit wait
        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        mgr.save(6, state)
        mgr.wait_until_finished()
        assert mgr.latest_step() == 6

    def test_gc_keeps_latest(self, tmp_path):
        from difffe_tpu.utils import CheckpointManager
        mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
        for s in [1, 2, 3, 4]:
            mgr.save(s, {"x": jnp.asarray(s)})
        assert mgr.steps() == [3, 4]

    def test_restore_missing_raises(self, tmp_path):
        from difffe_tpu.utils import CheckpointManager
        mgr = CheckpointManager(str(tmp_path / "ck"))
        with pytest.raises(FileNotFoundError):
            mgr.restore(99)

    def test_resume_training_reproduces_trajectory(self, tmp_path):
        """Kill-and-resume must reproduce the uninterrupted run exactly
        (SURVEY.md §5 failure-recovery gate)."""
        import optax
        from difffe_tpu.mesh import FEMesh
        from difffe_tpu.solver import solve_poisson
        from difffe_tpu.utils import CheckpointManager

        mesh = FEMesh.line(n_elements=16)
        f = jnp.ones(mesh.n_nodes)
        u_data = solve_poisson(mesh, 2.0, f)
        opt = optax.adam(0.1)

        @jax.jit
        def step(k, st):
            loss, g = jax.value_and_grad(
                lambda k: jnp.mean((solve_poisson(mesh, jnp.abs(k), f)
                                    - u_data) ** 2))(k)
            upd, st = opt.update(g, st)
            return optax.apply_updates(k, upd), st

        # uninterrupted: 20 steps
        k = jnp.asarray(1.0, mesh.dtype)
        st = opt.init(k)
        for _ in range(20):
            k, st = step(k, st)

        # interrupted at 10, checkpoint, restore, 10 more
        k2 = jnp.asarray(1.0, mesh.dtype)
        st2 = opt.init(k2)
        for _ in range(10):
            k2, st2 = step(k2, st2)
        mgr = CheckpointManager(str(tmp_path / "ck"))
        mgr.save(10, {"k": k2, "st": st2})
        rest = mgr.restore(10, template={"k": k2, "st": st2})
        k3, st3 = rest["k"], rest["st"]
        for _ in range(10):
            k3, st3 = step(k3, st3)
        assert abs(float(k3) - float(k)) < 1e-12


class TestMetrics:
    def test_jsonl_stream(self, tmp_path):
        from difffe_tpu.utils import MetricsLogger
        path = str(tmp_path / "m.jsonl")
        log = MetricsLogger(path=path)
        log.log(0, loss=1.5, solves_per_s=100.0)
        log.log(1, loss=0.5)
        log.close()
        lines = [json.loads(l) for l in open(path)]
        assert lines[0]["loss"] == 1.5
        assert lines[1]["step"] == 1
        assert log.last("solves_per_s") == 100.0


class TestConfig:
    def test_baseline_configs_present(self):
        from difffe_tpu.utils import BASELINE_CONFIGS
        assert set(BASELINE_CONFIGS) == {
            "demo_1d", "batched_inverse_1d", "heat_mpc_1d",
            "kappa_field_2d", "topopt_2d"}

    def test_roundtrip(self):
        from difffe_tpu.utils import ScenarioConfig
        cfg = ScenarioConfig(name="t", batch=7, extra={"z": 1})
        d = json.loads(cfg.to_json())
        cfg2 = ScenarioConfig.from_dict(d)
        assert cfg2 == cfg

    def test_unknown_keys_to_extra(self):
        from difffe_tpu.utils import ScenarioConfig
        cfg = ScenarioConfig.from_dict({"name": "t", "weird": 9})
        assert cfg.extra["weird"] == 9


class TestProfiling:
    def test_timeit(self):
        from difffe_tpu.utils import timeit_jax
        fn = jax.jit(lambda x: x * 2.0)
        t = timeit_jax(fn, jnp.ones(128), iters=5)
        assert t.mean_s > 0 and t.min_s > 0
        assert t.throughput(128) > 0

    def test_roofline_classification(self):
        from difffe_tpu.utils import TimingResult, roofline
        t = TimingResult(mean_s=1e-3, min_s=1e-3, iters=1)
        h100 = "NVIDIA H100 80GB HBM3"
        r_mem = roofline(t, flops=1e6, bytes_moved=1e9, device_kind=h100)
        assert r_mem.bound == "memory"
        # 1 GB in 1 ms against the 3.35 TB/s data-sheet bandwidth
        np.testing.assert_allclose(r_mem.bandwidth_fraction, 1000 / 3350)
        r_cmp = roofline(t, flops=1e12, bytes_moved=1e6, device_kind=h100)
        assert r_cmp.bound == "compute"
        np.testing.assert_allclose(r_cmp.flops_fraction, 1000 / 67)
        r_bf = roofline(t, flops=1e12, bytes_moved=1e6, device_kind=h100,
                        dtype="bf16")
        np.testing.assert_allclose(r_bf.flops_fraction, 1000 / 989)

    def test_h100_peaks_carry_their_source(self):
        from difffe_tpu.utils import device_peaks
        p = device_peaks("NVIDIA H100 80GB HBM3")
        assert (p.bf16_tflops, p.tf32_tflops, p.f32_tflops,
                p.hbm_gbps) == (989.0, 495.0, 67.0, 3350.0)
        assert "data sheet" in p.source

    @pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                      "NVIDIA H100 PCIe", ""])
    def test_unknown_device_kind_raises(self, kind):
        from difffe_tpu.utils import TimingResult, device_peaks, roofline
        with pytest.raises(ValueError, match="no published peaks"):
            device_peaks(kind)
        t = TimingResult(mean_s=1e-3, min_s=1e-3, iters=1)
        with pytest.raises(ValueError, match="no published peaks"):
            roofline(t, flops=1.0, bytes_moved=1.0, device_kind=kind)


class TestCLI:
    def test_list(self, capsys):
        from difffe_tpu.cli import main
        assert main(["list"]) == 0
        out = capsys.readouterr().out
        assert "demo_1d" in out and "topopt_2d" in out

    def test_run_demo(self, capsys):
        from difffe_tpu.cli import main
        main(["run", "demo_1d", "--steps", "50"])
        out = capsys.readouterr().out.strip().splitlines()[-1]
        rec = json.loads(out)
        assert rec["scenario"] == "demo_1d"
        assert rec["kappa_max_error"] < 0.5  # 50 steps, partial convergence

    def test_bench_small(self, capsys):
        from difffe_tpu.cli import main
        main(["bench", "batched_inverse_1d", "--batch", "32"])
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["grad_solves_per_s"] > 0

    def test_bench_2d_structured(self, capsys):
        from difffe_tpu.cli import main
        import dataclasses
        from difffe_tpu.utils.config import BASELINE_CONFIGS
        from difffe_tpu.cli import bench_scenario
        cfg = dataclasses.replace(BASELINE_CONFIGS["kappa_field_2d"],
                                  n_elements=8, batch=2,
                                  extra={"cg_iters": 64})
        rec = bench_scenario(cfg, log=lambda s: None)
        assert rec["grid"] == "8x8"
        assert rec["grad_solves_per_s"] > 0


class TestTraceCapture:
    def test_trace_writes_profile(self, tmp_path):
        from difffe_tpu.utils import trace
        logdir = str(tmp_path / "prof")
        with trace(logdir):
            jax.block_until_ready(jax.jit(lambda x: x * 2)(jnp.ones(64)))
        import os
        found = []
        for root, _, files in os.walk(logdir):
            found.extend(files)
        assert found, "no profiler artifacts written"


class TestScalingHarness:
    def test_weak_scaling_smoke(self):
        """scaling_efficiency runs on device subsets of the fake mesh
        (numbers are meaningless on shared-host CPU; shape/API checked)."""
        from difffe_tpu.parallel.multihost import scaling_efficiency
        from difffe_tpu.parallel import make_device_mesh, batch_sharding
        from difffe_tpu.mesh import FEMesh
        from difffe_tpu.solver import solve_poisson_batched

        fe_mesh = FEMesh.line(n_elements=16)

        def step_fn(kb, fb):
            return solve_poisson_batched(fe_mesh, kb, fb,
                                         kappa_batched=True)

        jitted = jax.jit(step_fn)

        def make_args(n_dev):
            B = 4 * n_dev
            kb = jnp.linspace(1.0, 2.0, B)
            fb = jnp.ones((B, fe_mesh.n_nodes))
            dmesh = make_device_mesh(n_devices=n_dev)
            sh = batch_sharding(dmesh)
            return jax.device_put(kb, sh), jax.device_put(fb, sh)

        results = scaling_efficiency(jitted, make_args, [1, 2], iters=3)
        assert set(results) == {1, 2}
        for thr, eff in results.values():
            assert thr > 0 and eff > 0

    def test_export_and_serve_roundtrip(self, tmp_path):
        """CLI export → serve: JSONL request in, solution out."""
        import subprocess, sys, os, json as _json
        art = str(tmp_path / "solver.bin")
        from difffe_tpu.cli import main
        assert main(["export", art, "--dim", "1", "--elements", "8",
                     "--batch", "2"]) == 0
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))))
        req = _json.dumps({"kappa": [1.0, 2.0],
                           "f": [[1.0] * 9, [1.0] * 9]})
        bad = "{not json"
        proc = subprocess.run(
            [sys.executable, "-m", "difffe_tpu.cli", "serve", art],
            input=req + "\n" + bad + "\n", capture_output=True,
            text=True, env=env, timeout=240)
        lines = [l for l in proc.stdout.splitlines() if l.strip()]
        assert len(lines) == 2, proc.stderr[-500:]
        resp = _json.loads(lines[0])
        u = np.asarray(resp["u"])
        assert u.shape == (2, 9)
        # kappa=2 halves the solution
        np.testing.assert_allclose(u[1], u[0] / 2.0, atol=1e-6)
        err = _json.loads(lines[1])
        assert "error" in err
