"""The reference agrees with the port at `tiny_config()` on the CPU, where
the port runs its plain forms: the agent tick (f32, and bf16 with the
int8 scope) over several ticks, and the distillation step's first loss
and gradients."""

import copy

import pytest
import torch

from lavbench import traffic as T
from lavbench.loops import distill as D
from lavbench.ref.agent import agent as R
from lavbench.ref.config import tiny_config as ref_tiny
from lavbench.ref.nn import quant as RQ
from lavbench.ref.train import distill as RD
from lavbench.tests.helpers import LIDAR
from lavbench.weights import Draw

IMG = (64, 64)
P = 256


def _port_models(ref_models, cfg, quant):
    from lav_tpu_torch.agent.agent import AgentModels
    from lav_tpu_torch.nn import quant as Q

    models = AgentModels(cfg, brake_version=2)
    models.load_state_dict(ref_models.state_dict())
    if quant:
        Q.quantize_tree(models.lidar_model)
        Q.quantize_tree(models.uniplanner)
    return models.eval()


@pytest.mark.parametrize("quant,dtype,pallas", [
    (False, torch.float32, True), (True, torch.bfloat16, False)])
def test_agent_tick_matches_the_port(quant, dtype, pallas):
    from lav_tpu_torch.agent.agent import build_agent
    from lav_tpu_torch.config import tiny_config

    torch.set_num_threads(2)
    kw = dict(num_frame_stack=2, num_features=[16, 16])
    cfg, rcfg = tiny_config(**kw), ref_tiny(**kw)
    ref_models = Draw.make(lambda d: R.AgentModels(rcfg, gen=d,
                                                   brake_version=2), 7, "cpu")
    models = _port_models(ref_models, cfg, quant)
    rmodels = copy.deepcopy(ref_models)
    if quant:
        RQ.quantize_tree(rmodels.lidar_model)
        RQ.quantize_tree(rmodels.uniplanner)
    obs_calib = [T.make_obs_np(1, P, IMG, 42 + t, "cpu") for t in range(2)]
    for m, build, q in ((models, build_agent, None), (rmodels, R.build_agent,
                                                      RQ)):
        if quant:
            init1, step1 = build(cfg if q is None else rcfg, max_points=P,
                                 rgb_hw=IMG, device="cpu")

            def calib(m=m, init1=init1, step1=step1):
                st = init1()
                for o in obs_calib:
                    _, st, _ = step1(m, st, o)
            if q is None:
                from lav_tpu_torch.nn import quant as Q
                Q.calibrate(calib)
            else:
                q.calibrate(calib)
    kw = dict(num_ego=3, max_points=P, rgb_hw=IMG, compute_dtype=dtype,
              use_pallas=pallas, device="cpu")
    init_p, step_p = build_agent(cfg, **kw)
    init_r, step_r = R.build_agent(rcfg, **kw)
    pool = T.obs_pool(dict(num_ego=3, points_per_sweep=P, img_hw=list(IMG),
                           lidar=LIDAR, pool=2), 5, "cpu")
    sp, sr = init_p(), init_r()
    for t in range(4):
        cp, sp, ap = step_p(models, sp, pool[t % 2])
        cr, sr, ar = step_r(rmodels, sr, pool[t % 2])
        for a, b in zip(cp, cr):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for k in ("bev", "plan_locs", "other_cast_locs", "pred_bra"):
            torch.testing.assert_close(ap[k], ar[k], rtol=0, atol=0)
        torch.testing.assert_close(sp.lidar_buf, sr.lidar_buf, rtol=0,
                                   atol=0)


def test_distill_first_step_matches_the_port():
    from lav_tpu_torch.config import tiny_config
    from lav_tpu_torch.train.distill import (
        adam, distill_models, make_full_train_step,
    )

    torch.set_num_threads(2)
    cfg, rcfg = tiny_config(), ref_tiny()
    ref = Draw.make(lambda d: RD.distill_models(rcfg, gen=d), 9, "cpu")
    prog = distill_models(cfg)
    prog.load_state_dict(ref.state_dict())
    rmod = copy.deepcopy(ref)
    gen = torch.Generator().manual_seed(3)
    batch = T.batch(gen, rcfg, 8, 64, "cpu")
    noise = T.noise(torch.Generator().manual_seed(4), rcfg, 8, "cpu")
    out = []
    for m, a, mk in ((prog, adam, make_full_train_step),
                     (rmod, RD.adam, RD.make_full_train_step)):
        opt = a(m)
        metrics = mk(cfg if mk is make_full_train_step else rcfg, v2=True,
                     mode="full")(m, opt, batch, noise=noise)
        out.append((float(metrics["loss"]), D.first_grads(m, opt)))
    (lp, gp), (lr, gr) = out
    assert lp == pytest.approx(lr, rel=1e-6)
    assert set(gp) == set(gr)
    med = sorted(gr.values())[len(gr) // 2]
    for k in gr:
        assert abs(gp[k] - gr[k]) <= 1e-4 * max(gr[k], med), k
