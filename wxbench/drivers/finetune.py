"""Traffic kind ``finetune``: the port's ``Trainer.train_step`` step after
step on (IC, target) pairs from a seeded pool in host memory, given as
numpy batches as ``FineTuneDataset`` gives them.

Set-up builds one trainer (the model's parameters drawn on the device,
``TrainConfig`` from the mix's parameters) and drives it through its first
``checked_steps`` steps on pairs that all differ: they warm every shape
and are what the reference follows.  After step 1 each leaf's first
gradient is read from the optimizer's state (AdamW's first moment over
1 − β1: the clipped gradient it received); after the last checked step
each leaf's change from its drawn value.  The same trainer then runs the
window; a step counts when it has completed inside it.

Once the window has closed and the trainer is freed, the reference
(``reference/train.py`` over the family's plain f32 loss) runs the checked
steps from the same drawn leaves on the same pairs; ``correct`` compares
the losses, the first gradients and the changes (``harness.compare``).
"""

from __future__ import annotations

import time

import torch

from wxbench.harness import compare, draw


def _config(tr):
    from skyrim_tpu_torch.finetune.trainer import TrainConfig

    return TrainConfig(batch_size=tr["batch_size"], rollout_steps=tr["rollout_steps"], remat=tr["remat"],
                       learning_rate=tr["learning_rate"], weight_decay=tr["weight_decay"], grad_clip=tr["grad_clip"])


def setup(run) -> None:
    from skyrim_tpu_torch.finetune.trainer import Trainer

    tr, fam, dev, st = run.traffic, run.family, run.torch_device, run.state
    run.phase("device query and the port's modules")
    model, params, weights = fam.build(run.cfg, dev, run.seed)
    trainer = Trainer(model, params, _config(tr))
    del params
    run.phase("model, weights and trainer")
    gen = draw.generator(dev, run.seed, "pairs")
    mean, std = weights["norm.mean"].to(dev), weights["norm.std"].to(dev)
    C, H, W = mean.shape[0], run.cfg["lat"], run.cfg["lon"]
    n_out = tr["rollout_steps"] * model.frames_out
    pool = []
    for _ in range(tr["pool"]):
        x = torch.randn((tr["batch_size"], fam.N_HISTORY, C, H, W), generator=gen, device=dev).mul_(std).add_(mean)
        y = torch.randn((tr["batch_size"], n_out, C, H, W), generator=gen, device=dev).mul_(std).add_(mean)
        pool.append((x.cpu().numpy(), y.cpu().numpy()))
    del x, y
    run.phase("pair pool")
    losses, first_grad = [], None
    for i in range(tr["checked_steps"]):
        losses.append(float(trainer.train_step(*pool[i])))
        if i == 0:
            b1 = trainer.opt.defaults["betas"][0]
            # a leaf the optimizer never stepped has no state: it received nothing
            first_grad = {n.replace("/", "."): (trainer.opt.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - b1)).cpu()
                          for n, p in trainer.leaves.items()}
    after = {n.replace("/", "."): p.detach().to("cpu", copy=True) for n, p in trainer.leaves.items()}
    run.phase("checked steps")
    st.update(trainer=trainer, pool=pool, weights=weights,
              program={"losses": losses, "first_grad": first_grad, "params": after})


def window(run) -> None:
    st, tr = run.state, run.traffic
    trainer, pool = st["trainer"], st["pool"]
    t0 = time.perf_counter()
    t_end = t0 + run.seconds
    steps, i, last = 0, tr["checked_steps"], t0
    while True:
        trainer.train_step(*pool[i % len(pool)])
        if run.device != "cpu":
            torch.cuda.synchronize()
        t = time.perf_counter()
        if t > t_end:
            break
        steps, i, last = steps + 1, i + 1, t
    run.steps = steps
    st["attempted"] = steps + 1
    st["last_step_s"] = last - t0


def release(run) -> None:
    run.state.pop("trainer", None)


def reference(run, quant=None) -> dict:
    """The reference's checked steps from the drawn leaves on the same pairs."""
    from wxbench.reference import train

    st, tr, fam, dev = run.state, run.traffic, run.family, run.torch_device
    w0 = {k: v.to(dev) for k, v in st["weights"].items()}
    batches = [(torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
               for x, y in st["pool"][: tr["checked_steps"]]]

    def loss(p, xs, ys):
        return fam.train_loss(p, run.cfg, xs, ys, tr["rollout_steps"], quant)

    return train.run_steps(w0, loss, batches, tr["learning_rate"], tr["weight_decay"], tr["grad_clip"])


def check(run) -> None:
    nums = compare.train_numbers(run.state["program"], reference(run), run.state["weights"])
    for name, value in nums.items():
        run.checks[name] = {"value": value, "limit": run.limits.get(name, 0.0)}


def readings(run, control: bool) -> dict:
    """The program's numbers and, with ``control``, the fp8 reference's in
    its place (``calibrate.py``)."""
    ref, p0 = reference(run), run.state["weights"]
    out = {k: [v] for k, v in compare.train_numbers(run.state["program"], ref, p0).items()}
    if control:
        out |= {"control." + k: [v] for k, v in compare.train_numbers(reference(run, "fp8"), ref, p0).items()}
    return out
