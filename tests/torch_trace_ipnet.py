"""Trace of the ipnet wild ``ours`` drift between the port and the JAX
package (ROADMAP §3): episode (dm-v5, scribble 3), interactions 1–3, on the
port's walk, with ``tests/torch_cells.py``'s harness (the committed demo
weights, BN-folded AssessNet, the JAX package following the port's picks
with its own backbone).

Run from the repository root on the CPU (about 2 minutes):
``JAX_PLATFORMS=cpu python tests/torch_trace_ipnet.py``. It prints:

1. each interaction's mean J&F in both packages;
2. per interaction, the first frame in propagation order whose probabilities
   differ by more than ``VOS_PROB_ATOL`` (2⁻⁵), or where a label flips with
   its winning probability further than that from its decision point;
3. the inputs of each interaction: whether both packages' robots drew the same
   scribbles, and the pixels whose label differs at the annotated frame in
   the interaction before, with both packages' probabilities;
4. the first differing interaction replayed stage by stage from the same state
   and the port's scribbles: the interaction output, ``ref_vector``, each
   propagation logit (fed the port's carry) and the Get_weight fusion on
   the same logit, then the fused maps running free.
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_cells as tc  # noqa: E402
from ivosw_tpu.core.config import Config as JaxConfig  # noqa: E402
from ivosw_tpu.models.vos import ipnet as jax_ipnet  # noqa: E402
from ivosw_tpu_torch.core.config import Config  # noqa: E402
from ivosw_tpu_torch.data.scribbles import scribble_masks_per_object  # noqa: E402
from ivosw_tpu_torch.models.vos.ipnet import get_weight, ref_vector  # noqa: E402
from ivosw_tpu_torch.models.vos.tapnet import prop_order  # noqa: E402

EPISODE = ("dm-v5", 3)
ROUNDS = 3
TOL = 2.0**-5  # chip_smoke.py's VOS_PROB_ATOL


class _Patch:
    def setattr(self, obj, name, value):
        setattr(obj, name, value)


def record(tmp):
    """Both packages' rounds on the port's walk: per round the annotated
    frame, the scribbles, the prob maps before and after, the labels."""
    vos, setting, method = "ipnet", "wild", "ours"
    params = tc.demo_weights("ipnet.orbax")
    agent, assess_net, jax_agent, assess_vars = tc._policy(vos, setting, method)
    picks, _ = tc.recording(_Patch(), tc.eval_agent, tc.recommend)
    rec = {"port": [], "jax": []}

    def recorded(side, segment, to_numpy):
        def wrapped(state, scribbles, a, n):
            before = to_numpy(state.prob_maps)
            labels, all_p, state = segment(state, scribbles, a, n)
            rec[side].append({"a": a, "scribbles": scribbles, "before": before,
                              "after": to_numpy(state.prob_maps), "labels": np.asarray(labels)})
            return labels, all_p, state
        return wrapped

    adapter = tc.port_adapter(vos, params)
    adapter.segment = recorded("port", adapter.segment, lambda x: x.clone().numpy())
    tc.eval_agent.evaluate(tc.cell_config(Config, vos, setting, method), tc.demo_registry(seed=0),
                           adapter, agent=agent, assess_net=assess_net,
                           max_nb_interactions=ROUNDS, report_save_dir=f"{tmp}/port",
                           samples=[EPISODE], device="cpu")
    jpicks, _ = tc.recording(_Patch(), tc.jax_eval, tc.jax_recommend)
    jax_pick = tc.jax_eval.recommend_frame

    def follow(*args, **kwargs):
        jax_pick(*args, **kwargs)
        return picks[len(jpicks) - 1]

    tc.jax_eval.recommend_frame = follow
    jadapter = jax_ipnet.IPNetAdapter(jax.tree.map(jnp.asarray, params))
    jadapter.segment = recorded("jax", jadapter.segment, np.asarray)
    tc.jax_eval.evaluate(tc.cell_config(JaxConfig, vos, setting, method),
                         tc.jax_demo_registry(seed=0), jadapter, agent=jax_agent,
                         assess_variables=assess_vars, max_nb_interactions=ROUNDS,
                         report_save_dir=f"{tmp}/jax", samples=[EPISODE])
    import csv

    for side in ("port", "jax"):
        means = {}
        for r in csv.DictReader(open(f"{tmp}/{side}/session_report.csv")):
            means.setdefault(int(r["interaction"]), []).append(
                (float(r["jaccard"]) + float(r["contour"])) / 2)
        print(side, "mean J&F by interaction:", {k: round(float(np.mean(v)), 4) for k, v in means.items()})
    print("port picks", list(picks), "JAX package's own picks", list(jpicks))
    return rec


def labels(pm):
    return np.where(pm.max(1) > 0.5, pm.argmax(1) + 1, 0)


def first_over(p, j):
    """First frame in propagation order over TOL (probabilities or a
    flipped label's margin), with its numbers."""
    a, t = p["a"], p["after"].shape[0]
    lp, lj = labels(p["after"]), labels(j["after"])
    for f in [a] + prop_order(t, a)[0].tolist():
        d = float(np.abs(p["after"][f] - j["after"][f]).max())
        flip = lp[f] != lj[f]
        margin = 0.0
        for pm in (p["after"][f], j["after"][f]):
            top = np.sort(pm, axis=0)
            decision = np.where(top[-2] > 0.5, top[-2], 0.5)
            if flip.any():
                margin = max(margin, float(np.abs(top[-1] - decision)[flip].max()))
        if d > TOL or margin > TOL:
            return f, d, int(flip.sum()), margin
    return None


def stages(rec, r):
    """Round r from each package's own state before it, with the port's
    scribbles in both: the stages of the round held side by side."""
    params = tc.demo_weights("ipnet.orbax")
    jp = jax.tree.map(jnp.asarray, params)
    adapter = tc.port_adapter("ipnet", params)
    frames = tc.demo_registry(seed=0).load_images(EPISODE[0])
    state = adapter.begin_sequence(frames, 2)
    jstate = jax_ipnet.IPNetAdapter(jp).begin_sequence(frames, 2)
    p = rec["port"][r]
    a, t, (h, w) = p["a"], frames.shape[0], frames.shape[1:3]
    earlier = np.array([x["a"] for x in rec["port"][:r]])
    scrib = scribble_masks_per_object(p["scribbles"], (h, w), a, 2, dilation=3)
    pos, neg = scrib[1:], np.clip(scrib.sum(0)[None] - scrib[1:], 0, 1)
    prop = jax.jit(lambda *x: jax_ipnet.IPNet().apply({"params": jp}, *x, (h, w),
                                                    method=jax_ipnet.IPNet.propagate))
    order, reset, _ = prop_order(t, a)
    fuse_w = get_weight(t, earlier, a)
    for side in ("port", "jax"):
        before = rec[side][r]["before"]
        img = torch.from_numpy(frames[a]).permute(2, 0, 1)[None].expand(2, 3, h, w)
        with torch.no_grad():
            anno = torch.sigmoid(adapter.net.interaction(
                img, torch.from_numpy(pos), torch.from_numpy(neg), torch.from_numpy(before[a])))
        janno = np.asarray(jax_ipnet._interact_jit(
            jp, jnp.broadcast_to(jnp.asarray(frames[a])[None], (2, h, w, 3)), jnp.asarray(pos),
            jnp.asarray(neg), jnp.asarray(before[a])))
        with torch.no_grad():
            rv = ref_vector(state.feats[0][a], anno)
        jrv = np.asarray(jax_ipnet._ref_vector(jstate.feats[0][a], jnp.asarray(anno.numpy())))
        worst = {"logit": (0.0, None), "fusion": (0.0, None), "free": (0.0, None)}
        carry, jcarry = anno, jnp.asarray(anno.numpy())
        for k, f in enumerate(order.tolist()):
            if reset[k] > 0:
                carry, jcarry = anno, jnp.asarray(anno.numpy())
            ex = lambda x: x[f][None].expand((2,) + x.shape[1:])
            jex = lambda x: jnp.broadcast_to(x[f][None], (2,) + x.shape[1:])
            with torch.no_grad():
                logit = adapter.net.propagation(ex(state.feats[0]), ex(state.feats[1]),
                                                ex(state.feats[2]), rv, carry, (h, w))
            same = np.asarray(prop(jex(jstate.feats[0]), jex(jstate.feats[1]),
                                   jex(jstate.feats[2]), jnp.asarray(rv.numpy()),
                                   jnp.asarray(carry.numpy())))
            jlogit = prop(jex(jstate.feats[0]), jex(jstate.feats[1]), jex(jstate.feats[2]),
                          jnp.asarray(jrv), jcarry)
            wf = fuse_w[f]
            fused = float(wf) * torch.sigmoid(logit) + float(1 - wf) * torch.from_numpy(before[f])
            jsame = wf * jax.nn.sigmoid(jnp.asarray(logit.numpy())) + (1.0 - wf) * before[f]
            jfused = wf * jax.nn.sigmoid(jlogit) + (1.0 - wf) * jnp.asarray(before[f])
            for key, d in (("logit", np.abs(logit.numpy() - same).max()),
                           ("fusion", np.abs(fused.numpy() - np.asarray(jsame)).max()),
                           ("free", np.abs(fused.numpy() - np.asarray(jfused)).max())):
                if d > worst[key][0]:
                    worst[key] = (float(d), f)
            carry, jcarry = fused, jfused
        print(f"interaction {r + 1} from the {side} state, the port's scribbles: interaction "
              f"{np.abs(anno.numpy() - janno).max():.4g}, ref_vector "
              f"{np.abs(rv.numpy() - jrv).max():.4g} (of {np.abs(jrv).max():.4g}), "
              f"logit fed the same carry {worst['logit'][0]:.4g} (frame {worst['logit'][1]}), "
              f"fusion of the same logit {worst['fusion'][0]:.3g}, fused maps running free "
              f"{worst['free'][0]:.4g} (frame {worst['free'][1]})")


def main():
    import tempfile

    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        rec = record(tmp)
    first_round = None
    for r, (p, j) in enumerate(zip(rec["port"], rec["jax"])):
        over = first_over(p, j)
        same = all(np.array_equal(a, b) for a, b in zip(
            scribble_masks_per_object(p["scribbles"], p["labels"].shape[1:], p["a"], 2, 3),
            scribble_masks_per_object(j["scribbles"], p["labels"].shape[1:], p["a"], 2, 3)))
        strokes = lambda x: [s["object_id"] for s in x["scribbles"]["scribbles"][x["a"]]]
        print(f"interaction {r + 1}: annotated frame {p['a']}; scribbles equal: {same} (strokes by "
              f"object: port {strokes(p)}, JAX {strokes(j)}); first frame over {TOL}: "
              f"{over and dict(zip(('frame', 'max_abs_diff', 'flips', 'flip_margin'), over))}")
        if r:
            prev_p, prev_j = rec["port"][r - 1], rec["jax"][r - 1]
            a = p["a"]
            differ = np.nonzero(prev_p["labels"][a] != prev_j["labels"][a])
            print(f"  after interaction {r}, frame {a}: labels differ on {len(differ[0])} pixels")
            for y, x in list(zip(*differ))[:3]:
                print(f"  after interaction {r}, frame {a}, pixel ({y}, {x}): label port "
                      f"{prev_p['labels'][a][y, x]} JAX {prev_j['labels'][a][y, x]}; "
                      f"probabilities port {prev_p['after'][a][:, y, x]} "
                      f"JAX {prev_j['after'][a][:, y, x]}")
        if over and first_round is None:
            first_round = r
    if first_round:
        stages(rec, first_round)


if __name__ == "__main__":
    main()
