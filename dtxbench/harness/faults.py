"""Faults planted under the timed path, for the tests that show the
comparison catches them and for the chip readings that set the limits'
upper ends. Each is a function the drivers call with what they time: the
training step function (returns a broken one) or the serving engine."""

from __future__ import annotations


def state_unchanged(step):
    """A step that returns the state it was given."""
    def broken(state, batch):
        _, metrics = step(state, batch)
        return state, metrics
    return broken


def half_batch(step):
    """Half of the batch left out: the step's mean over the rest."""
    def broken(state, batch):
        half = {k: (v[:len(v) // 2] if hasattr(v, "__len__") else v)
                for k, v in batch.items()}
        return step(state, half)
    return broken


def altered_token(engine, at: int = 2):
    """Every stream's token ``at`` replaced by its successor id where the
    engine hands it to the request. Patches the request class until
    ``engine._dtxbench_restore()`` (the tests run one engine)."""
    from datatunerx_tpu_torch.serving import batched_engine as be

    vocab = engine.cfg.vocab_size
    push = be.Request.push

    def broken(self, token):
        if len(self.tokens) == at:
            token = (token + 1) % vocab
        return push(self, token)

    be.Request.push = broken
    engine._dtxbench_restore = lambda: setattr(be.Request, "push", push)


def kv_unwritten(engine):
    """A decode step that returns its state unchanged: one-token forwards
    leave the KV pools as they were (the dense-view path writes into
    copies, the kernel path skips the write). Patches the model module
    until ``engine._dtxbench_restore()``."""
    from datatunerx_tpu_torch.models import llama

    write, update = llama.kv_cache_write_paged, llama.kv_cache_update

    def broken_write(cache, ck, cv, cks, cvs, k, v, targets=None):
        if k.shape[1] == 1:
            return None
        return write(cache, ck, cv, cks, cvs, k, v, targets)

    def broken_update(cache, ck, cv, cks, cvs, k, v, targets=None):
        if k.shape[1] == 1:
            ck, cv, cks, cvs = (None if x is None else x.clone()
                                for x in (ck, cv, cks, cvs))
        return update(cache, ck, cv, cks, cvs, k, v, targets)

    llama.kv_cache_write_paged, llama.kv_cache_update = (broken_write,
                                                         broken_update)

    def restore():
        llama.kv_cache_write_paged, llama.kv_cache_update = write, update

    engine._dtxbench_restore = restore


def sampler_unit_temperature(engine):
    """A sampler that draws every sampled row at temperature 1, whatever
    the request asked. Patches the engine module's sampling call until
    ``engine._dtxbench_restore()``."""
    import torch

    from datatunerx_tpu_torch.serving import batched_engine as be

    sample = be.fused_sample

    def broken(logits, temps, top_ps, us, *, mode):
        temps = torch.where(temps > 0, torch.ones_like(temps), temps)
        return sample(logits, temps, top_ps, us, mode=mode)

    be.fused_sample = broken
    engine._dtxbench_restore = lambda: setattr(be, "fused_sample", sample)


TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch}
SERVE = {"altered_token": altered_token, "kv_unwritten": kv_unwritten,
         "sampler_unit_temperature": sampler_unit_temperature}
