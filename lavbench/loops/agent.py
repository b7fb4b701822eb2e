"""The batched agent tick, closed loop: `num_ego` lockstep egos, the next
tick issued once the last one's controls are on the host.

Set-up builds the port's agent as `agent/setup.py::v2_agent_setup` builds
it (`build_agent`, `AgentModels`, `quantize_tree`, `calibrate_agent`),
with the benchmark's weights loaded into `AgentModels`, and warms every
shape up with `warmup` ticks.  The window cycles a pool of observation
sets, the agent's state carried from tick to tick.

Correctness: the window keeps two ticks (its first and one drawn from
the seed in the traffic's `check_tick` range, after the ring buffer of
sweeps has filled) with the state each
started from and the lidar model's features (a forward hook on the
program's lidar model copies them out for the sampled egos).  After the window the reference (`ref/`, in the
configuration's precision) runs each of them from that state for a
sample of egos drawn from the seed, and each stage is compared: the
painted sweep the tick pushed (seg + paint), the BEV map (pillars,
backbone, heads), the vehicle detections (peak decode), the brake net
(its pooled features, which its classifier reads, and its probability),
the planner's crop embeddings (crops and crop ResNet, on the program's
features and detections: a forward hook on the program's crop ResNet
copies its output out), the planner's GRUs and cast (the reference's crop
ResNet hands on the program's output in place of its own, so that the
rollouts are judged on the same embeddings) and the controls with their
overrides, and the new state.  The planner reads the program's
features and detections and the control reads the program's stage
outputs, as a
served model's reference reads its served tokens, so that a tie in the
decode does not move the later stages; the detections themselves are
judged against the reference's maps.  So `control` and `state` judge the
PID, the overrides and the EKF alone: what the stages before them
produce is judged by the stages' own numbers.  The brake net is also
run in f32 on the same inputs, as a second witness to the gap between
the two sides in the compute dtype (read, not compared).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from lavbench import counts, traffic as T
from lavbench.loops.common import (
    DTYPES, Phases, model_fields, rel, take, tf32,
)
from lavbench.ref import record
from lavbench.ref.agent import agent as R
from lavbench.ref.config import LAVConfig as RefConfig
from lavbench.ref.nn import quant as RQ
from lavbench.weights import Draw

HOOKED = ("feats", "emb", "emb_raw", "bra_feat")  # copied out for the egos
CALIB_SEED = 42
CALIB_TICKS = 2
BIG = 1e9     # a number compared that cannot be computed


class Agent:
    unit = "tick"
    prefix = "agent/"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from lav_tpu_torch.agent.agent import AgentModels, build_agent
        from lav_tpu_torch.agent.setup import calibrate_agent
        from lav_tpu_torch.config import LAVConfig
        from lav_tpu_torch.nn import quant as Q
        from lav_tpu_torch.utils import native

        self.config, self.traffic, self.seed = config, traffic, seed
        self.dev = torch.device(device)
        self.phases = phases = Phases(device)
        prec, prog = config["precision"], config["program"]
        self.cdt = DTYPES[prec["compute_dtype"]]
        self.quant = prec["int8"]
        self.use_pallas = prog["use_pallas"]
        self.E = traffic["num_ego"]
        self.P = traffic["points_per_sweep"]
        self.img_hw = tuple(traffic["img_hw"])
        tf32(prec["tf32"])
        if self.dev.type == "cuda":
            native.build_all()
        phases("kernels")
        fields = model_fields(config)
        self.cfg, self.ref_cfg = LAVConfig(**fields), RefConfig(**fields)
        # the weights: the reference's models drawn on the device, loaded
        # into the program's
        self.ref_models = Draw.make(
            lambda d: R.AgentModels(self.ref_cfg, brake_version=2, gen=d),
            seed, self.dev)
        with torch.device(self.dev):
            models = AgentModels(self.cfg, brake_version=2)
        models.load_state_dict(self.ref_models.state_dict())
        if self.quant == "mxu":
            Q.quantize_tree(models.lidar_model)
            Q.quantize_tree(models.uniplanner)
        elif self.quant is not None:
            raise ValueError(f"int8 scope {self.quant!r}")
        self.models = models.eval()
        phases("weights")
        if self.quant:
            calibrate_agent(self.models, self.cfg, self.P, self.img_hw,
                            self.dev)
        phases("calibrate")
        init_state, self.step = build_agent(
            self.cfg, num_ego=self.E, max_points=self.P, rgb_hw=self.img_hw,
            compute_dtype=self.cdt, use_pallas=self.use_pallas,
            device=self.dev)
        self.pool = T.obs_pool(traffic, seed, self.dev)
        self.state = init_state()
        phases("traffic")
        self.i = 0
        rng = np.random.default_rng(seed)
        self.keep_at = {0, int(rng.integers(*traffic["check_tick"]))}
        self.egos = np.sort(rng.choice(self.E, traffic["check_egos"],
                                       replace=False))
        self.kept = []
        # the lidar model's features of the kept ticks, for the egos the
        # check samples: the reference's planner reads them
        self.feats = self.emb = self.emb_raw = self.bra_feat = None
        self.egos_dev = torch.as_tensor(self.egos, device=self.dev)
        self.models.lidar_model.register_forward_hook(self._feats_hook)
        self.models.uniplanner.lidar_conv_emb.register_forward_hook(
            self._emb_hook)
        self.models.bra_model.classifier.register_forward_hook(
            self._bra_hook)
        for _ in range(traffic["warmup"]):
            self._tick(record=False)
        self.i = 0
        phases("warmup")

    def _feats_hook(self, module, args, out):
        if self.i in self.keep_at:
            self.feats = out[0][self.egos_dev]

    def _bra_hook(self, module, args, out):
        if self.i in self.keep_at:
            self.bra_feat = args[0][self.egos_dev].float()

    def _emb_hook(self, module, args, out):
        if self.i in self.keep_at:
            raw = out.reshape(self.E, -1, *out.shape[1:])[self.egos_dev]
            self.emb_raw = raw
            self.emb = crop_embedding(raw.flatten(0, 1), len(self.egos))

    def _tick(self, record=True):
        obs_i = self.i % len(self.pool)
        state = self.state
        ctrl, new_state, aux = self.step(self.models, state,
                                         self.pool[obs_i])
        host = torch.stack(list(ctrl)).cpu()
        if record and self.i in self.keep_at:
            self.kept.append((self.i, state, obs_i, host, new_state,
                              dict(aux, feats=self.feats, emb=self.emb,
                                   emb_raw=self.emb_raw,
                                   bra_feat=self.bra_feat)))
        self.feats = self.emb = self.emb_raw = self.bra_feat = None
        self.state = new_state
        self.i += 1

    def unit_call(self):
        """One timed tick: until its controls are on the host."""
        self._tick()

    def e2e(self, times, window_s) -> dict:
        return {"ego_ticks_per_s": self.E * len(times) / window_s,
                "tick_ms_p95": float(np.percentile(np.asarray(times) * 1e3,
                                                   95))}

    def release(self):
        """Free the program's state before the reference runs; what the
        check compares is kept."""
        if len(self.kept) < len(self.keep_at):
            raise RuntimeError(f"the window ended after {self.i} ticks, "
                               f"before tick {max(self.keep_at)} that the "
                               "check compares")
        idx = self.egos_dev
        self.kept = [(i, take(s, idx), take(self.pool[o], idx),
                      h[:, idx.cpu()], take(ns, idx),
                      dict(take({k: v for k, v in aux.items()
                                 if k not in HOOKED}, idx),
                           **{k: aux[k] for k in HOOKED}))
                     for i, s, o, h, ns, aux in self.kept]
        self.models = self.step = self.pool = self.state = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference ---------------------------------------------------

    def _ref_agent(self, qmax: int):
        """The reference's models quantized and calibrated with QMAX
        `qmax` (left set), and its step for the sampled egos."""
        models = copy.deepcopy(self.ref_models)
        RQ.QMAX = qmax
        if self.quant == "mxu":
            RQ.quantize_tree(models.lidar_model)
            RQ.quantize_tree(models.uniplanner)
        models.eval()
        if self.quant:
            init1, step1 = R.build_agent(self.ref_cfg, max_points=self.P,
                                         rgb_hw=self.img_hw, device=self.dev)

            def run():
                state = init1()
                for t in range(CALIB_TICKS):
                    obs = T.make_obs_np(1, self.P, self.img_hw,
                                        CALIB_SEED + t, self.dev)
                    _, state, _ = step1(models, state, obs)
            RQ.calibrate(run)
        _, step = R.build_agent(self.ref_cfg, num_ego=len(self.egos),
                                max_points=self.P, rgb_hw=self.img_hw,
                                compute_dtype=self.cdt,
                                use_pallas=self.use_pallas, device=self.dev)
        return models, step

    def check(self, control: bool = False):
        """(numbers computed, least-work counts a tick).  With `control`
        the reference one precision below the configuration's (int8 convs
        in int4, and every f32 matmul and conv in TF32) stands in the
        program's place."""
        prec = self.config["precision"]
        models, step = self._ref_agent(127)
        n_ego = len(self.egos)
        embs, raws, bras, fed = {}, {}, {}, {}

        def capture(m, key):
            """Copy out `m`'s crop ResNet output (pooled and raw) and brake
            features under `key`; the crop ResNet hands on `fed[key]` in
            place of its own output when that is set."""
            def emb_fn(module, args, out):
                embs[key] = crop_embedding(out, n_ego)
                raws[key] = out.reshape(n_ego, -1, *out.shape[1:])
                if key in fed:
                    return fed[key].reshape(out.shape).to(out.dtype)

            def bra_fn(module, args, out):
                bras[key] = args[0].float()
            m.uniplanner.lidar_conv_emb.register_forward_hook(emb_fn)
            m.bra_model.classifier.register_forward_hook(bra_fn)
        capture(models, "ref")
        if control:
            c_qmax = 7 if self.quant else 127
            c_models, c_step = self._ref_agent(c_qmax)
            capture(c_models, "control")
            RQ.QMAX = 127
        got, tallied = [], None
        for n, (i, state, obs, host, new_state, aux) in enumerate(self.kept):
            if control:
                tf32(True)
                RQ.QMAX = c_qmax
                ctrl, new_state, aux = c_step(c_models, state, obs)
                aux = dict(aux, emb=embs["control"], emb_raw=raws["control"],
                           bra_feat=bras["control"])
                host = torch.stack(list(ctrl)).cpu()
                RQ.QMAX = 127
                tf32(prec["tf32"])
            fed["ref"] = aux["emb_raw"]
            feed = dict(dets=aux["dets"], feats=aux["feats"],
                        plan_wps=aux["plan_locs"],
                        other_cast_locs=aux["other_cast_locs"],
                        other_cast_cmds=aux["other_cast_cmds"],
                        other_valid=aux["other_valid"],
                        pred_bra=aux["pred_bra"])
            calls = [] if n == 0 else None
            record.CALLS = calls
            if calls is not None:
                from torch.utils.flop_counter import FlopCounterMode
                with FlopCounterMode(display=False) as fc:
                    r_ctrl, r_state, r_aux = step(models, state, obs, feed)
                flops = fc.get_total_flops()
            else:
                r_ctrl, r_state, r_aux = step(models, state, obs, feed)
            record.CALLS = None
            if calls is not None:
                tallied = self._per_tick(calls, flops)
            nums = compare(state, host, new_state, aux, r_ctrl, r_state,
                           dict(r_aux, emb=embs["ref"], bra_feat=bras["ref"]))
            nums.update(brake_witness(self.ref_models.bra_model, obs,
                                      aux["pred_bra"],
                                      r_aux["own"]["pred_bra"]))
            got.append(nums)
        numbers = {k: (float(np.median([g[k] for g in got]))
                       if k.endswith("_med") else max(g[k] for g in got))
                   for k in got[0]}
        return numbers, tallied

    def _per_tick(self, calls, flops) -> dict:
        """The least work of one tick of all egos, from the reference's
        calls for the sampled egos."""
        return counts.per_unit(
            calls, flops, self.E / len(self.egos),
            counts.PEAKS[self.config["precision"]["compute_dtype"]])


def compare(state, host, new_state, aux, r_ctrl, r_state, r_aux) -> dict:
    """The numbers of one tick: for each stage its gap per sampled ego,
    as the largest over the egos and (`_med`) their median."""
    per = {}
    E = host.shape[1]
    ar = torch.arange(E, device=state.buf_ptr.device)
    slot = state.buf_ptr.long()
    per["paint"] = rel(new_state.lidar_buf[ar, slot], r_aux["painted"],
                       dim=0)
    per["bev"] = rel(aux["bev"], r_aux["bev"], dim=0)
    per["emb"] = rel(aux["emb"], r_aux["emb"], dim=0)
    per["det"] = det_gap(aux["dets"], r_aux["dets"], r_aux["maps"])
    own = r_aux["own"]
    per["brake"] = rel(aux["bra_feat"], r_aux["bra_feat"], dim=0)
    per["brake_prob"] = (aux["pred_bra"].double() -
                         own["pred_bra"].double()).abs()
    cmds = (aux["other_cast_cmds"].double() - own["other_cast_cmds"].double()
            ).abs().flatten(1).max(dim=1).values
    valid = (aux["other_valid"] == own["other_valid"]).all(dim=1)
    per["plan"] = torch.where(
        valid, torch.stack([rel(aux["plan_locs"], own["plan_wps"], dim=0),
                            rel(aux["other_cast_locs"],
                                own["other_cast_locs"], dim=0),
                            cmds]).max(dim=0).values, BIG)
    out = {}
    for k, v in per.items():
        v = torch.nan_to_num(v.double(), nan=BIG, posinf=BIG)
        out[k] = v.max().item()
        out[k + "_med"] = v.median().item()
    r_host = torch.stack(list(r_ctrl)).cpu()
    out["control"] = (host - r_host).abs().max().item()
    out["state"] = state_gap(new_state, r_state, slot)
    return {k: (v if np.isfinite(v) else BIG) for k, v in out.items()}


def brake_witness(bra_model, obs, pred_bra, r_pred_bra) -> dict:
    """The brake net in f32 on the same inputs: how far each side's
    probability lies from it (`brake_f32`: the program's, `brake_ref_f32`:
    the reference's), and the largest |logit| of the f32 run."""
    logits = []
    handle = bra_model.classifier.register_forward_hook(
        lambda m, a, out: logits.append(out.float()))
    rgbs = obs["rgbs"]
    wide = torch.cat([rgbs[:, i] for i in range(rgbs.shape[1])], dim=2)
    with torch.no_grad():
        f32 = bra_model(wide.float(), obs["tel_rgb"].float()).double()
    handle.remove()
    return {"brake_f32": (pred_bra.double() - f32).abs().max().item(),
            "brake_ref_f32": (r_pred_bra.double() - f32).abs().max().item(),
            "brake_logit_f32": logits[0].abs().max().item()}


def crop_embedding(out, num_ego: int) -> torch.Tensor:
    """The planner's crop embeddings (num_ego, K + 1, 512) in f32 from its
    crop ResNet's output (num_ego * (K + 1), 512, h, w): the pooling of
    `models/planner.py::conv_emb`."""
    emb = out.float().mean(dim=(2, 3))
    return emb.reshape(num_ego, -1, emb.shape[-1])


def det_gap(dets, r_dets, maps) -> torch.Tensor:
    """How far each ego's vehicle detections lie from the reference's: the
    largest of the gap between the sorted score lists (suppressed slots as
    0), the gap between each program peak's score and the reference's
    heatmap at its pixel, and the gaps of its size and orientation there
    (relative where above 1)."""
    hm, size, ori = maps
    ps = dets["score"].float().clamp(min=0)
    rs = r_dets["score"].float().clamp(min=0)
    gaps = [(ps.sort(dim=-1).values - rs.sort(dim=-1).values).abs()]
    e = torch.arange(ps.shape[0], device=ps.device)[:, None]
    y, x = dets["y"].long(), dets["x"].long()
    real = ps > 0
    gaps.append((hm[e, 1, y, x] - ps).abs() * real)
    for name, m, c in (("w", size, 0), ("h", size, 1), ("cos", ori, 0),
                       ("sin", ori, 1)):
        r = m[e, c, y, x]
        gaps.append((dets[name].float() - r).abs() / r.abs().clamp(min=1.0)
                    * real)
    return torch.stack([g.max(dim=-1).values for g in gaps]).max(dim=0).values


def state_gap(new_state, r_state, slot) -> float:
    """The new state against the reference's: each float field by its
    relative error (the ring buffer's pushed slot is `paint`'s), every
    integer and boolean field exactly."""
    worst = 0.0
    E = slot.shape[0]
    ar = torch.arange(E, device=slot.device)
    for name, p, r in _fields(new_state, r_state):
        if name == "lidar_buf":
            p, r = p.clone(), r.clone()
            p[ar, slot] = 0
            r[ar, slot] = 0
            if not torch.equal(p, r):
                return BIG
            continue
        if p.dtype.is_floating_point:
            worst = max(worst, rel(p, r, dim=0).max().item())
        elif not torch.equal(p, r):
            return BIG
    return worst


def _fields(a, b, prefix=""):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if hasattr(x, "_fields"):
            yield from _fields(x, y, prefix + name + ".")
        else:
            yield prefix + name, x, y


Loop = Agent
