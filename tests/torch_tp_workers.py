"""What each rank runs in ``test_torch_vocab_tp.py``: module-level functions
for ``distributed.spawn_local``, which imports this module in every rank.
It imports torch, numpy and the port only (no JAX), so that a rank starts
in a few seconds; the test module makes the inputs and the JAX side."""

import numpy as np
import torch

from myimagecaptioningmodel_tpu_torch.compat.from_jax import reference_tree, train_tree
from myimagecaptioningmodel_tpu_torch.config import Config
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from myimagecaptioningmodel_tpu_torch.parallel import distributed as tdist
from myimagecaptioningmodel_tpu_torch.parallel import mesh as tmesh
from myimagecaptioningmodel_tpu_torch.parallel import train_step as tts
from myimagecaptioningmodel_tpu_torch.parallel import vocab_parallel as VP
from myimagecaptioningmodel_tpu_torch.training import lr_schedules as tlr


def flat(tree, prefix=""):
    """Nested dicts and lists -> {"a/0/b": float64 numpy}."""
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list, tuple)):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float64)
    return out


# ---- the layers ----------------------------------------------------------------------


def _layers(d, lo, hi, vp: bool):
    """The embedding, the head and the CE (with and without smoothing) on
    rows [lo, hi) of the table (``vp``: through ``vocab_parallel``) ->
    values and gradients."""
    table = torch.tensor(d["table"][lo:hi], requires_grad=True)
    bias = torch.tensor(d["bias"][lo:hi], requires_grad=True)
    x = torch.tensor(d["x"], requires_grad=True)
    ids, target = torch.tensor(d["ids"]), torch.tensor(d["target"])
    out = {}
    emb = (VP.embed if vp else _plain_embed)({"table": table}, ids, 0)
    out["embed"] = emb.detach().numpy()
    out["embed_dtable"] = torch.autograd.grad((emb * torch.tensor(d["g_emb"])).sum(),
                                              table)[0].numpy()
    for eps in (0.0, 0.1):
        proj = VP.head_input(x) if vp else x
        logits = proj @ table.T + bias
        if vp:
            ce = VP.cross_entropy(logits, target, d["real_v"], eps)
        else:
            logz = torch.logsumexp(logits, -1)
            ce = logz - logits.gather(-1, target[..., None])[..., 0]
            if eps:
                ce = (1 - eps) * ce + eps * (logz - logits[..., :d["real_v"]].mean(-1))
        loss = (ce * torch.tensor(d["w"])).sum()
        gx, gt, gb = torch.autograd.grad(loss, (x, table, bias))
        out[f"ce{eps}"] = ce.detach().numpy()
        out[f"ce{eps}_dx"], out[f"ce{eps}_dtable"], out[f"ce{eps}_dbias"] = (
            gx.numpy(), gt.numpy(), gb.numpy())
    return out


def _plain_embed(p, ids, padding_idx):
    return p["table"][ids] * (ids != padding_idx).unsqueeze(-1).to(p["table"].dtype)


def layers_rank(rank, d):
    """Each rank's rows through ``vocab_parallel``, and the merge's tie rule
    on planted ties -> outputs."""
    tdist.set_grid(2)
    V = d["table"].shape[0]
    lo, hi = rank * V // 2, (rank + 1) * V // 2
    out = {"vp": _layers(d, lo, hi, True), "rows": (lo, hi)}
    # ties: equal values on both ranks, the lower global index must win
    ties = d["ties"]
    out["merge"] = VP.merge_argmax(torch.tensor(ties["value"][rank]),
                                   torch.tensor(ties["index"][rank])).numpy()
    return out


def layers_single(d):
    V = d["table"].shape[0]
    return _layers(d, 0, V, False)


# ---- one train step --------------------------------------------------------------------


def step_rank(rank, cfg_dict, params, state, images, caps, mp):
    """One train step on a (data=world/mp, model=mp) grid from the numpy
    tree -> the loss, the full trees (gathered), the BN state, and what this
    rank held."""
    cfg = Config.from_dict(cfg_dict)
    torch.manual_seed(0)
    mesh = tmesh.make_mesh(device="cpu", model_parallel=mp)
    opts = tcap.ModelOptions.from_config(cfg)._replace(vocab_parallel=mp > 1)
    schedule = tlr.from_config(cfg)
    optimizer = tts.make_optimizer(cfg, schedule)
    tp, ts = train_tree(params, state, device="cpu", dtype=torch.float64)
    to = optimizer.init(tp)
    tp, to = tmesh.shard_state(mesh, tp, to)
    local_rows = tp["decoder"]["embedding"]["table"].shape[0]
    steps = tts.build_steps(opts, optimizer, schedule)
    idx = tdist.local_rows(np.arange(images.shape[0]))
    tp, to, ts, _, loss, _ = steps.train_step(tp, to, ts, 0, torch.as_tensor(images[idx]),
                                              torch.as_tensor(caps[idx]))
    fp, fo = tmesh.gather_state(mesh, tp, to)
    p, s = (flat(t) for t in reference_tree(fp, ts))
    mu, nu = (flat(reference_tree(tts.tree_unflatten(fp, m), {})[0]) for m in fo.adam[1:])
    ema = flat(reference_tree(tts.ema_params_from_opt_state(fo), {})[0])
    return {"loss": float(loss), "params": p, "state": s, "mu": mu, "nu": nu, "ema": ema,
            "local_rows": local_rows}


# ---- the loop --------------------------------------------------------------------------


def loop_rank(rank, cfg_dict):
    """``loop.train`` on this rank -> its summary and the files it wrote."""
    import os

    from myimagecaptioningmodel_tpu_torch.training import loop as tloop

    cfg = Config.from_dict(cfg_dict)
    written = []
    orig = tloop.ckpt.write_checkpoint

    def counted(directory, *a, **k):
        written.append(os.path.basename(directory))
        return orig(directory, *a, **k)

    tloop.ckpt.write_checkpoint = counted
    try:
        summary = tloop.train(cfg, device="cpu")
    finally:
        tloop.ckpt.write_checkpoint = orig
    return {"summary": summary, "written": written,
            "grid": (tdist.data_size(), tdist.data_index(), tdist.model_index())}
