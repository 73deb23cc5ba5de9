"""Elastic fault-tolerant training controller.

Counterpart of ``mxnet_tpu/module/elastic.py``. ``Module.fit(elastic=...)``
routes here. ``ElasticFit`` wraps the bind → init_params → init_optimizer →
per-batch loop with three things:

1. **Periodic asynchronous checkpoints** off the step path: in sharded
   update mode (``MXNET_KVSTORE_UPDATE=sharded``) each worker hands its 1/W
   flat optimizer shard to ``checkpoint.Checkpointer``; otherwise rank 0
   saves the weights and the optimizer state pickle (the fused step's
   through ``SPMDStepAdapter.freeze``). Either way the state is copied on
   the card when the save is made, and the writer thread brings it to the
   host and to disk while the next steps run (``checkpoint.inflight`` > 0
   while it does).

2. **The pause protocol**: worker death becomes a *pause decision* in the
   coordination store (``dist.propose_pause``; first write wins) naming the
   dead set and an agreed ``pause_at`` round. Every worker trains through
   exactly that round. Proposers: a SIGTERM'd worker draining itself, and
   the coordinator's per-round heartbeat scan (crashes).

3. **Re-form + resume**: at the pause round survivors drain in-flight
   buckets, snapshot or reach for the newest complete checkpoint, re-form
   the process group over W−1 (``dist.reform`` → ``KVStore.reform``),
   rescale the gradient normalization, reseed weights and optimizer state,
   fast-forward the data iterator and keep training. Workers named dead
   exit cleanly through ``EvictedError``.

What differs from the JAX package: a torch tensor does not belong to a
process group, so after a re-form the bound executors and their arrays stay
valid and are reseeded in place (JAX re-binds, since its arrays die with the
old backend). Not survivable: the coordinator's death (its process hosts
the store), dropping below ``MXNET_ELASTIC_MIN_WORKERS``, and a crash with
no complete checkpoint to reseed from.
"""
from __future__ import annotations

import logging
import os
import signal
import time

import numpy as np

from .. import metric as metric_mod
from .. import telemetry as _tm
from ..base import EvictedError, MXNetError

__all__ = ["ElasticFit"]


# copied from mxnet_tpu/module/elastic.py (_env_int; backend-free)
def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return int(default)


class ElasticFit:
    """Elastic training loop for one Module (see the module docstring).

    Parameters
    ----------
    module : Module
        Must run the per-key kvstore path (``fused_step=False``) when
        distributed elastically — the fused step cannot re-form its mesh.
    checkpoint_dir : str, optional
        Sharded-checkpoint root; default ``MXNET_CHECKPOINT_DIR``. Without
        one, recovery falls back to the pause-time all-gather snapshot,
        which only a DRAINING departure can provide.
    checkpoint_period : int, optional
        Rounds between async checkpoints; default ``MXNET_CHECKPOINT_STEPS``
        (25). 0 disables periodic checkpoints.
    check_interval : int, optional
        Rounds between the coordinator's heartbeat scans (default 1).
    resume : bool
        Load the newest complete checkpoint under ``checkpoint_dir`` at fit
        start (any world size) and fast-forward the iterator to its
        recorded position.
    reseed : str
        Where a re-form reseeds state from: ``"auto"`` prefers the
        pause-time snapshot on a clean drain and the newest complete
        checkpoint otherwise; ``"checkpoint"`` always reseeds from the
        checkpoint (deterministic rollback). Must be the same on every
        worker.
    """

    def __init__(self, module, checkpoint_dir=None, checkpoint_period=None,
                 check_interval=1, resume=True, reseed="auto", logger=None):
        from .. import checkpoint as ckpt

        self._mod = module
        self.logger = logger or getattr(module, "logger", logging)
        self.checkpoint_dir = checkpoint_dir or ckpt.checkpoint_dir()
        self.checkpoint_period = (
            _env_int("MXNET_CHECKPOINT_STEPS", 25)
            if checkpoint_period is None else int(checkpoint_period))
        self.check_interval = max(1, int(check_interval))
        self.resume = resume
        if reseed not in ("auto", "checkpoint"):
            raise MXNetError("elastic reseed must be 'auto' or 'checkpoint', got %r" % (reseed,))
        self.reseed = reseed
        self.evicted = False
        self._writer = None
        self._drain = False
        self._pending_pause = None
        self._resuming = False
        self._round = 0          # update rounds since step 0, ALL generations
        self._old_sigterm = None
        # recovery → loop directives
        self._resume_epoch = None
        self._resume_nbatch = None

    # ------------------------------------------------------------ properties
    @property
    def kv(self):
        return self._mod._kvstore

    def _dist(self):
        from .. import dist

        return dist

    def _elastic_dist(self):
        """True when the pause/re-form protocol is live: an elastic dist job
        spanning >1 process."""
        dist = self._dist()
        kv = self.kv
        return (kv is not None and "dist" in kv.type
                and dist.elastic_enabled() and kv.num_workers > 1)

    # -------------------------------------------------------------- lifecycle
    def _install_sigterm(self):
        def _on_term(signum, frame):
            self._drain = True

        try:
            self._old_sigterm = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:  # not the main thread
            self._old_sigterm = None

    def _restore_sigterm(self):
        if self._old_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._old_sigterm)
            except ValueError:
                pass
            self._old_sigterm = None

    def _ensure_writer(self):
        from .. import checkpoint as ckpt

        if self._writer is None and self.checkpoint_dir:
            self._writer = ckpt.Checkpointer(self.checkpoint_dir)
        return self._writer

    # ------------------------------------------------------------------- fit
    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="dist_tpu_sync", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None):
        """The elastic counterpart of ``BaseModule.fit`` (same contract; no
        ``monitor``)."""
        assert num_epoch is not None, "please specify number of epochs"
        from ..initializer import Uniform

        mod = self._mod
        if initializer is None:
            initializer = Uniform(0.01)
        mod.bind(data_shapes=train_data.provide_data, label_shapes=train_data.provide_label,
                 for_training=True, force_rebind=force_rebind)
        mod.init_params(initializer=initializer, arg_params=arg_params,
                        aux_params=aux_params, allow_missing=allow_missing,
                        force_init=force_init)
        mod.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                           optimizer_params=optimizer_params, force_init=force_init)
        if mod._spmd is not None and self._elastic_dist():
            raise MXNetError(
                "elastic training needs the per-key kvstore path: build the "
                "Module with fused_step=False (the fused step cannot re-form "
                "its mesh over a changed process set)")

        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        resume_epoch, resume_nbatch = begin_epoch, 0
        if self.resume and self.checkpoint_dir:
            got = self._try_resume()
            if got is not None:
                resume_epoch, resume_nbatch = got

        self._install_sigterm()
        try:
            self._run_epochs(train_data, eval_data, eval_metric, validation_metric,
                             epoch_end_callback, batch_end_callback, eval_end_callback,
                             eval_batch_end_callback, resume_epoch, resume_nbatch, num_epoch)
        except EvictedError as e:
            # the expected exit of a drained/written-off worker: finish
            # cleanly so launchers see rc=0 (the SURVIVORS carry the job)
            self.evicted = True
            self.logger.info("elastic: %s", e)
        finally:
            self._restore_sigterm()
            if self._writer is not None:
                try:
                    self._writer.close()
                except MXNetError as e:
                    self.logger.warning("elastic: final checkpoint drain failed: %s", e)
        return self

    # ------------------------------------------------------------ main loop
    def _run_epochs(self, train_data, eval_data, eval_metric, validation_metric,
                    epoch_end_callback, batch_end_callback, eval_end_callback,
                    eval_batch_end_callback, begin_epoch, begin_nbatch, num_epoch):
        from .base_module import BatchEndParam, _as_list

        mod = self._mod
        epoch = begin_epoch
        resume_nbatch = begin_nbatch
        while epoch < num_epoch:
            tic = time.time()
            eval_metric.reset()
            restart = False
            for nbatch, data_batch in enumerate(train_data):
                if nbatch < resume_nbatch:
                    continue  # fast-forward to the resume point
                try:
                    mod.forward_backward(data_batch)
                    mod.update()
                    # under the guard too: a dead peer's failure can surface
                    # at any read, the metric's output pull included
                    mod.update_metric(eval_metric, data_batch.label)
                except EvictedError:
                    raise
                except Exception as exc:
                    # a CRASHED peer breaks the round's collective long
                    # before its heartbeat goes stale: route the failure into
                    # the pause protocol; re-raises when no member died
                    directive = self._recover_from_crash(exc, epoch, nbatch)
                    if directive == "recovered":
                        epoch = self._resume_epoch
                        resume_nbatch = self._resume_nbatch
                        restart = True
                        break
                    raise exc
                if _tm.enabled():
                    _tm.mark_step()
                self._round += 1
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                                           locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(params)
                directive = self._on_round(epoch, nbatch)
                if directive == "recovered":
                    epoch = self._resume_epoch
                    resume_nbatch = self._resume_nbatch
                    restart = True
                    break
            if restart:
                train_data.reset()
                continue
            resume_nbatch = 0
            # a training megastep's partial final buffer lands before the
            # epoch's metric is read (as BaseModule.fit does)
            flush_pending = getattr(mod, "flush_pending_steps", None)
            if flush_pending is not None:
                flush_pending(eval_metric)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)
            arg_params_, aux_params_ = mod.get_params()
            mod.set_params(arg_params_, aux_params_)
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, mod.symbol, arg_params_, aux_params_)
            if eval_data:
                res = mod.score(eval_data, validation_metric,
                                score_end_callback=eval_end_callback,
                                batch_end_callback=eval_batch_end_callback, epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name, val)
            train_data.reset()
            epoch += 1

    # ----------------------------------------------------------- round hook
    def _on_round(self, epoch, nbatch):
        """Everything elastic at a round boundary: the periodic checkpoint,
        the drain/scan pause proposals, the poll and — at the agreed round —
        the pause itself. Returns ``"recovered"`` when a re-form happened and
        the loop must re-enter at the recorded resume point."""
        kv = self.kv
        if self._resuming:
            kv._set_elastic_state("running")
            self._resuming = False
        if self.checkpoint_period and self.checkpoint_dir \
                and self._round % self.checkpoint_period == 0:
            self._save_checkpoint(epoch, nbatch)
        if not self._elastic_dist():
            if self._drain:
                # drain outside the elastic protocol: best-effort checkpoint,
                # then stop — and say exactly what was saved
                saved = self._save_checkpoint(epoch, nbatch, block=True)
                if not self.checkpoint_dir:
                    raise EvictedError(
                        "SIGTERM drain at round %d with NO checkpoint_dir "
                        "configured — nothing was saved; stopping training" % self._round)
                if kv is not None and "dist" in kv.type and kv.num_workers > 1:
                    raise EvictedError(
                        "SIGTERM drain at round %d: local state written "
                        "under %r, but a NON-elastic multi-worker job "
                        "cannot commit a complete checkpoint from one rank "
                        "(the manifest is rank 0's) — launch with "
                        "--elastic / MXNET_ELASTIC=1 for survivable "
                        "drains; stopping training" % (self._round, self.checkpoint_dir))
                if not saved:
                    raise EvictedError(
                        "SIGTERM drain at round %d: the final checkpoint "
                        "save FAILED (see warning above) — resume from the "
                        "previous complete step under %r; stopping "
                        "training" % (self._round, self.checkpoint_dir))
                raise EvictedError("SIGTERM drain: checkpoint written at round %d; "
                                   "stopping training" % self._round)
            return None
        dist = self._dist()
        payload = self._pending_pause
        if payload is None:
            if self._drain:
                payload = dist.propose_pause([dist.orig_rank()], self._round)
                self.logger.info("elastic: SIGTERM — draining at round %d (pause_at %d)",
                                 self._round, payload["pause_at"])
            elif dist.orig_rank() == 0 and self._round % self.check_interval == 0:
                # never name ourselves dead: this process is running the scan
                dead = [d for d in dist.dead_members() if d != dist.orig_rank()]
                if dead:
                    payload = dist.propose_pause(dead, self._round)
                    self.logger.warning("elastic: dead member(s) %s — pausing at round %d",
                                        dead, payload["pause_at"])
            if payload is None:
                payload = dist.poll_pause()
            self._pending_pause = payload
        if payload is not None and self._round >= int(payload["pause_at"]):
            # the payload is first-write-wins and pause_at carries a margin,
            # so every rank reads the SAME payload before that round
            # graphlint: waive GL801 -- pause payload is rank-uniform (above)
            return self._execute_pause(payload, epoch, nbatch)
        return None

    # ------------------------------------------------------------ checkpoint
    def _save_checkpoint(self, epoch, nbatch, block=False):
        """True when the save was submitted (and, for blocking saves,
        landed); False when no writer is configured or it failed."""
        writer = self._ensure_writer()
        if writer is None:
            return False
        kv = self.kv
        meta = {"epoch": int(epoch), "nbatch": int(nbatch), "round": int(self._round)}
        eng = kv._bucket_engine if kv is not None else None
        try:
            if eng is not None and eng.mode == "sharded" and eng._sharded_state:
                extra = self._aux_extra() if self._rank() == 0 else None
                writer.save_sharded(kv, self._round, extra=extra, meta=meta, block=block)
            else:
                self._save_replicated(writer, meta, block=block)
            return True
        except MXNetError as e:
            # a failed checkpoint must not kill training — the NEXT save
            # re-raises through the writer's latch if the disk stays bad
            self.logger.warning("elastic: checkpoint at round %d failed: %s", self._round, e)
            return False

    def _rank(self):
        return self.kv.rank if self.kv is not None else 0

    def _aux_extra(self):
        """Aux params (BN moving stats etc.) as rank-0 extra files: they
        never flow through the kvstore, but a resume needs them."""
        _, aux = self._mod.get_params()
        return {"aux:%s" % k: v for k, v in aux.items()} or None

    def _save_replicated(self, writer, meta, block=False):
        kv = self.kv
        mod = self._mod
        if self._rank() != 0:
            return  # rank 0 writes the full replicated weights
        if mod._spmd is not None:
            # the fused step owns the weights and the optimizer state: its
            # flat buffers freeze with a clone each, and the state pickle is
            # made on the writer thread
            weights, states = mod._spmd.freeze()
        else:
            args, auxs = mod.get_params()
            weights = {"arg:%s" % k: v for k, v in args.items()}
            weights.update({"aux:%s" % k: v for k, v in auxs.items()})
            updater = kv._updater if kv is not None and kv._updater is not None \
                else mod._updater
            states = updater.get_states() if updater is not None else None
        writer.save_replicated(self._round, weights, states_bytes=states, meta=meta,
                               world=kv.num_workers if kv is not None else 1, rank=0,
                               block=block)

    def _try_resume(self):
        """Load the newest complete checkpoint at fit start; returns the
        recorded ``(epoch, nbatch + 1)`` resume point or None."""
        from .. import checkpoint as ckpt

        got = ckpt.latest_complete(self.checkpoint_dir)
        if got is None:
            return None
        step, manifest = got
        self._seed_from_checkpoint(step, manifest)
        meta = manifest.get("meta", {})
        self._round = int(meta.get("round", step))
        epoch = int(meta.get("epoch", 0))
        nbatch = int(meta.get("nbatch", -1))
        self.logger.info(
            "elastic: resumed from checkpoint step %d (epoch %d, batch %d, "
            "saved by a %d-worker run)", step, epoch, nbatch, int(manifest.get("world", 0)))
        return epoch, nbatch + 1

    def _seed_from_checkpoint(self, step, manifest):
        """Weights + optimizer state from a checkpoint step into the
        kvstore, the module and the bound executors."""
        from .. import checkpoint as ckpt

        kv = self.kv
        mod = self._mod
        if manifest.get("kind") == "sharded":
            if kv is None:
                raise MXNetError("sharded checkpoint %d needs a kvstore-backed fit" % step)
            _, weights = kv.load_sharded_checkpoint(self.checkpoint_dir, step=step)
            names = mod._param_names
            args = {}
            for key, w in weights.items():
                name = names[key] if isinstance(key, int) and key < len(names) else key
                args[name] = w
            auxs = {k[len("aux:"):]: v for k, v in ckpt.read_extra(
                self.checkpoint_dir, step, manifest).items() if k.startswith("aux:")}
        else:
            d = ckpt.step_dir(self.checkpoint_dir, step)
            blob = ckpt._load_npz_checked(os.path.join(d, "weights.npz"))
            args = {k[len("arg:"):]: v for k, v in blob.items() if k.startswith("arg:")}
            auxs = {k[len("aux:"):]: v for k, v in blob.items() if k.startswith("aux:")}
            states_path = os.path.join(d, "states.bin")
            if os.path.exists(states_path):
                # the module's own loader: the fused step's state, the
                # store's per-key states (the bucket engine reseeds from
                # them) or the module's updater, either package's pickle
                mod.load_optimizer_states(states_path)
        self._adopt_params(args, auxs)

    def _adopt_params(self, args, auxs):
        """Write host weight arrays into the module's params and executors
        AND the kvstore's stored values (the pull source of truth). The
        executors' tensors outlive a re-form of the process group, so they
        are written in place."""
        from .. import ndarray as nd

        mod = self._mod
        ctx = mod._context[0]
        args_nd = {k: nd.array(np.asarray(v), ctx=ctx) for k, v in args.items()}
        auxs_nd = {k: nd.array(np.asarray(v), ctx=ctx) for k, v in (auxs or {}).items()}
        mod.set_params(args_nd, auxs_nd, allow_missing=True, force_init=True)
        kv = self.kv
        if kv is not None:
            names = mod._param_names
            for key in list(kv._store):
                name = names[key] if isinstance(key, int) and key < len(names) else key
                if name in args:
                    kv._reseed(key, kv._on_context(key, np.asarray(args[name])))

    # --------------------------------------------------------- crash path
    @staticmethod
    def _collective_suspect(exc):
        """Whether a step failure plausibly came from the collective fabric
        (a dead peer) rather than host-side code: torch.distributed's error
        types, or messages naming the transport. User-code bugs raise
        ordinary exceptions that match neither and surface at once."""
        if type(exc).__name__ in ("DistError", "DistBackendError", "DistNetworkError",
                                  "DistStoreError"):
            return True
        msg = str(exc)
        return any(t in msg for t in (
            "Gloo", "gloo", "NCCL", "collective", "Connection", "Timed out",
            "timed out", "DataLoss", "UNKNOWN:"))

    def _recover_from_crash(self, exc, epoch, nbatch):
        """A step failed mid-collective on an elastic job. If a member is
        (or becomes) dead, run the pause/re-form at once — the fabric is
        already broken, there is no round to train through — reseeding from
        the checkpoint only. Re-raises ``exc`` when no member death explains
        the failure within the staleness window."""
        if not self._elastic_dist():
            raise exc
        dist = self._dist()
        self.logger.warning("elastic: step at round %d failed (%s: %s) — checking for "
                            "dead members", self._round, type(exc).__name__, exc)
        payload = self._pending_pause or dist.poll_pause()
        if payload is None:
            dead = [d for d in dist.dead_members() if d != dist.orig_rank()]
            if not dead and not self._collective_suspect(exc):
                raise exc  # a host-side bug: surface it now
            # a hard-killed peer's sockets close fast; its heartbeat file
            # decays slower — wait out the staleness window for the evidence
            # (another survivor may publish the pause first)
            deadline = time.time() + dist.dead_timeout_seconds() + 30.0
            while not dead and payload is None and time.time() < deadline:
                time.sleep(min(1.0, dist.dead_timeout_seconds() / 4))
                dead = [d for d in dist.dead_members() if d != dist.orig_rank()]
                if not dead:
                    payload = dist.poll_pause()
            if payload is None:
                if not dead:
                    raise exc  # not a membership failure — let it surface
                payload = dist.propose_pause(dead, self._round)
        return self._execute_pause(payload, epoch, nbatch, crashed=True)

    # --------------------------------------------------------------- pause
    def _execute_pause(self, payload, epoch, nbatch, crashed=False):
        """The agreed pause round was reached: drain, snapshot-or-checkpoint,
        re-form over the survivors, reseed, resume (or exit through
        EvictedError when this worker is in the dead set)."""
        from .. import checkpoint as ckpt

        dist = self._dist()
        kv = self.kv
        t0 = time.time()
        kv._set_elastic_state("paused")
        self.logger.info("elastic: paused at round %d (payload %s%s)", self._round, payload,
                         ", after collective failure" if crashed else "")
        if self._writer is not None:
            try:
                self._writer.wait()  # in-flight async shard writes must land
            except MXNetError as e:
                # a failed LAST write only moves the agreed reseed step back
                self.logger.warning("elastic: checkpoint drain at pause failed: %s", e)
        eng = kv._bucket_engine
        if eng is not None:
            if crashed:
                eng.drain_inflight()  # handles on the broken group
            else:
                eng.finalize_all()  # symmetric: every member drains in-flight
        # a DRAIN departure leaves the full membership alive at the pause
        # round, so the all-gather snapshot is available; a crash leaves
        # only what reached the disk
        drain = not crashed and bool(payload.get("proposer") in payload.get("dead", ()))
        snapshot = self._snapshot_host() if drain else None
        try:
            plan = dist.plan_from_pause(payload)
        except EvictedError:
            dist.stop_heartbeat(remove=True)
            raise
        with _tm.span("dist.recover", generation=payload["generation"]):
            dist.reform(plan)
            kv.reform()
            self._rescale(plan)
            step = self._agree_checkpoint_step(payload["generation"])
            use_ckpt = step is not None and (self.reseed == "checkpoint" or snapshot is None)
            if use_ckpt:
                manifest = ckpt.load_manifest(self.checkpoint_dir, step)
                if manifest is None:
                    raise MXNetError(
                        "elastic recovery: agreed checkpoint step %d under "
                        "%r lost its manifest between agreement and load"
                        % (step, self.checkpoint_dir))
                self._seed_from_checkpoint(step, manifest)
                meta = manifest.get("meta", {})
                self._round = int(meta.get("round", step))
                self._resume_epoch = int(meta.get("epoch", epoch))
                self._resume_nbatch = int(meta.get("nbatch", nbatch)) + 1
            elif snapshot is not None:
                self._reseed_from_snapshot(snapshot)
                self._resume_epoch, self._resume_nbatch = epoch, nbatch + 1
            else:
                raise MXNetError(
                    "elastic recovery impossible: worker(s) %s died "
                    "without draining and no COMPLETE checkpoint exists "
                    "under %r — the dead workers' optimizer shards are "
                    "lost. Unrecoverable; restart the job"
                    % (payload.get("dead"), self.checkpoint_dir))
        kv._set_elastic_state("resuming")
        self._pending_pause = None
        self._resuming = True
        if _tm.enabled():
            _tm.counter("dist.recoveries").inc()
            _tm.event("dist.recovered", generation=payload["generation"], world=plan["world"],
                      seconds=round(time.time() - t0, 3))
        self.logger.info(
            "elastic: re-formed generation %d over %d worker(s) in %.2fs — "
            "resuming at epoch %d batch %d (round %d)", payload["generation"], plan["world"],
            time.time() - t0, self._resume_epoch, self._resume_nbatch, self._round)
        return "recovered"

    def _agree_checkpoint_step(self, generation):
        """The survivors must reseed from the SAME checkpoint step, and a
        shared-filesystem scan can race a manifest landing — so the
        coordinator's answer is published once in the store (first write
        stands) and everyone reads that. None = no complete checkpoint."""
        import datetime
        import json

        from .. import checkpoint as ckpt

        dist = self._dist()
        store = dist.coordination_client()
        key = "mxtpu-elastic/gen-%d/ckpt-step" % generation
        if dist.orig_rank() == 0:
            got = ckpt.latest_complete(self.checkpoint_dir) if self.checkpoint_dir else None
            store.compare_set(key, "", json.dumps(got[0] if got else -1))
        try:
            store.wait([key], datetime.timedelta(seconds=60))
            step = int(json.loads(store.get(key)))
        except RuntimeError as e:
            raise MXNetError(
                "elastic recovery: the coordinator never published the "
                "checkpoint-step agreement for generation %d (%s)" % (generation, e)) from e
        return None if step < 0 else step

    def _snapshot_host(self):
        """Pause-time host snapshot: replicated weights + per-key optimizer
        states (all-gathered from the flat shards in sharded mode). Taken
        by EVERY member — the all-gather is a collective."""
        kv = self.kv
        eng = kv._bucket_engine
        weights = {key: v.asnumpy() for key, v in kv._store.items()}
        states = {}
        if eng is not None and eng.mode == "sharded" and eng._sharded_state:
            states = eng.export_per_key_states()
        elif kv._updater is not None:
            for key, st in kv._updater.states.items():
                if st is None:
                    continue
                tup = st if isinstance(st, (tuple, list)) else (st,)
                states[key] = [s.asnumpy() for s in tup]
        _, aux = self._mod.get_params()
        auxs = {k: v.asnumpy() for k, v in aux.items()}
        return {"weights": weights, "states": states, "aux": auxs}

    def _reseed_from_snapshot(self, snapshot):
        """Seed the re-formed store/engine from the pause-time snapshot: no
        rollback, training resumes exactly where it paused."""
        kv = self.kv
        names = self._mod._param_names
        args = {}
        for key, w in snapshot["weights"].items():
            name = names[key] if isinstance(key, int) and key < len(names) else key
            args[name] = w
        self._adopt_params(args, snapshot["aux"])
        if kv._updater is not None:
            for key, arrs in snapshot["states"].items():
                nds = [kv._on_context(key, a) for a in arrs]
                kv._updater.states[key] = nds[0] if len(nds) == 1 else tuple(nds)
            if kv._bucket_engine is not None:
                kv._bucket_engine.reseed_updater_states()

    def _rescale(self, plan):
        """The gradient normalization 1/(batch·W) must track the new world
        size. The per-key updates and the bucket engine's flat update read
        ``rescale_grad`` at each call, so the new constant takes effect at
        the next round."""
        opt = self._mod._optimizer
        if opt is None:
            return
        old_world = plan["world"] + len(plan["dead"])
        opt.rescale_grad = opt.rescale_grad * old_world / plan["world"]
        self.logger.info("elastic: rescale_grad ×%d/%d → %g", old_world, plan["world"],
                         opt.rescale_grad)
