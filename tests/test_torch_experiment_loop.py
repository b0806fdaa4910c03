"""The port's experiment loop (``datatunerx_tpu_torch/experiment/{pool,
scheduler,watcher,runner}.py``) against the reference's, on the CPU.

- The 15 scenarios of ``tests/test_experiment_pool.py`` and the 8 of
  ``tests/test_experiment_loop.py`` run on both packages through one
  parametrised body (``pkg``), over each package's Fake backends and
  gateway: the slice pool's gang fit, the scheduler's admissions,
  preemptions and resumes, the watcher's leaderboard and early stop, the
  Scoring bridge, canary promotion and rollback, and ``dtx experiment
  --backend fake``. Checkpoints are the trainer's own: the reference's
  orbax steps, the port's ``<dir>/<step>/state.pt``;
- the same scripted experiment makes the same decisions in both packages:
  events, leaderboard, preemptions and promotion, tick for tick;
- the port lists a step only once its ``state.pt`` exists, and
  ``dtx-torch experiment`` runs the local backend's trainers on
  ``--device`` (``cuda`` unless the caller asks for the CPU).
"""

import importlib
import importlib.util
import json
import os
import threading
import time
import urllib.request
import uuid

import numpy as np
import pytest
import torch

from tests.torch_twin import PKGS, Twin

M = Twin(
    ExperimentMetrics="experiment.metrics:ExperimentMetrics",
    PoolSlice="experiment.pool:PoolSlice",
    SharedSlicePool="experiment.pool:SharedSlicePool",
    mesh_fits="experiment.pool:mesh_fits",
    ExperimentRunner="experiment.runner:ExperimentRunner",
    PHASE_DONE="experiment.runner:PHASE_DONE",
    PHASE_PROMOTE="experiment.runner:PHASE_PROMOTE",
    FAILED="experiment.scheduler:FAILED",
    PENDING="experiment.scheduler:PENDING",
    PREEMPTED="experiment.scheduler:PREEMPTED",
    RUNNING="experiment.scheduler:RUNNING",
    STOPPED="experiment.scheduler:STOPPED",
    SUCCEEDED="experiment.scheduler:SUCCEEDED",
    SliceScheduler="experiment.scheduler:SliceScheduler",
    ContinuousScoringWatcher="experiment.watcher:ContinuousScoringWatcher",
    Leaderboard="experiment.watcher:Leaderboard",
    scoring_cr_score="experiment.watcher:scoring_cr_score",
    InProcessReplica="gateway.replica_pool:InProcessReplica",
    ReplicaPool="gateway.replica_pool:ReplicaPool",
    Gateway="gateway.server:Gateway",
    serve="gateway.server:serve",
    FakeServingBackend="operator.backends:FakeServingBackend",
    FakeTrainingBackend="operator.backends:FakeTrainingBackend",
)


@pytest.fixture(params=PKGS)
def pkg(request):
    return M.use(request.param)


def _save_step(ckpt_dir, step, state):
    """``state`` saved as ``step`` by the trainer's own checkpointing: the
    reference's orbax ``CheckpointManager``, the port's ``state.pt``."""
    ckpt = M.mod("training.checkpoint")
    if M.pkg == "datatunerx_tpu_torch":
        ckpt.save_raw_state(ckpt_dir, step, {
            k: torch.from_numpy(v) for k, v in state.items()})
        return
    mngr = ckpt.CheckpointManager(ckpt_dir, save_interval_steps=1)
    assert mngr.maybe_save(state, step=step, force=True)
    mngr.close()


def _restore_step(ckpt_dir, state):
    """(the saved state, its step) through the path a resumed trainer
    takes."""
    ckpt = M.mod("training.checkpoint")
    if M.pkg == "datatunerx_tpu_torch":
        step = ckpt.saved_steps(ckpt_dir)[-1]
        saved = ckpt.load_raw_state(ckpt_dir, step)
        return {k: v.numpy() for k, v in saved.items()}, step
    mngr = ckpt.CheckpointManager(ckpt_dir)
    restored, step = mngr.restore(state)
    mngr.close()
    return restored, step


EIGHT = {"meshShape": "dp=8"}  # needs all 8 chips of a 2x4 slice
ANY = {}  # absorbs into whatever slice it gets


def make_sched(slices=("s0", "s1"), chips=8, metrics=None, probe=None):
    pool = M.SharedSlicePool([M.PoolSlice(n, chips=chips) for n in slices])
    backend = M.FakeTrainingBackend()
    kw = {}
    if probe is not None:
        kw["checkpoint_probe"] = probe
    sched = M.SliceScheduler(pool, backend, metrics=metrics, **kw)
    return sched, backend, pool


# ------------------------------------------------------------------- pool
def test_mesh_gang_fit_uses_trainer_mesh_parser(pkg):
    assert M.mesh_fits(EIGHT, 8)
    assert not M.mesh_fits(EIGHT, 4)  # dp=8 cannot tile 4 chips
    assert M.mesh_fits({"meshShape": "dp=2,tp=2"}, 4)
    assert not M.mesh_fits({"meshShape": "dp=3"}, 8)  # 3 doesn't tile 8
    assert M.mesh_fits(ANY, 8)  # absent meshShape absorbs


def test_pool_acquires_smallest_fitting_slice_and_releases(pkg):
    pool = M.SharedSlicePool([M.PoolSlice("big", chips=16),
                              M.PoolSlice("small", chips=8)])
    assert pool.acquire("flex", ANY).name == "small"  # smallest fit wins
    pool.release("flex")
    s = pool.acquire("job-a", EIGHT)
    assert s.name == "small"  # gang-fit is EXACT tiling: dp=8 ∉ 16 chips
    assert pool.acquire("job-a", EIGHT).name == "small"  # idempotent
    assert pool.acquire("job-b", EIGHT) is None  # big can't tile dp=8
    s2 = pool.acquire("job-b", {"meshShape": "dp=8,fsdp=2"})
    assert s2.name == "big"
    pool.release("job-a")
    assert pool.acquire("job-c", EIGHT).name == "small"


def test_pool_remove_slice_reports_displaced_holder(pkg):
    pool = M.SharedSlicePool([M.PoolSlice("s0"), M.PoolSlice("s1")])
    pool.acquire("job-a", ANY)
    assert pool.remove_slice("missing") is None
    held = pool.assignment("job-a").name
    other = "s1" if held == "s0" else "s0"
    assert pool.remove_slice(other) is None  # free slice: nobody displaced
    assert pool.remove_slice(held) == "job-a"
    assert pool.size() == 0


# -------------------------------------------------------------- scheduler
def test_scheduler_admits_up_to_pool_capacity(pkg):
    sched, backend, _ = make_sched()
    for n in ("job-a", "job-b", "job-c"):
        sched.add_job(n, {"parameters": EIGHT})
    events = sched.tick()
    assert [e["event"] for e in events] == ["started", "started"]
    states = {j.name: j.state for j in sched.jobs()}
    assert sorted(s for s in states.values()) == [M.PENDING, M.RUNNING,
                                                  M.RUNNING]
    assert set(backend.jobs) == {e["job"] for e in events}
    # a job finishing frees its slice for the pending one
    running = [n for n, s in states.items() if s == M.RUNNING]
    backend.set_state(running[0], "Succeeded")
    events = sched.tick()
    kinds = {e["event"] for e in events}
    assert kinds == {"succeeded", "started"}
    assert sched.job(running[0]).state == M.SUCCEEDED
    assert all(j.state in (M.RUNNING, M.SUCCEEDED) for j in sched.jobs())


def test_scheduler_failure_is_terminal_and_frees_slice(pkg):
    sched, backend, pool = make_sched(slices=("s0",))
    sched.add_job("job-a", {"parameters": EIGHT})
    sched.add_job("job-b", {"parameters": EIGHT})
    sched.tick()
    backend.set_state("job-a", "Failed")
    sched.tick()
    assert sched.job("job-a").state == M.FAILED
    assert sched.job("job-b").state == M.RUNNING
    assert pool.holder_of("s0") == "job-b"


def test_preempt_and_resume_via_orbax_restore_path(pkg, tmp_path):
    """Preemption records the job's latest saved step — probed through the
    trainer's own checkpoint listing — and the resumed submission carries
    it; the saved state actually restores through the path a resumed
    trainer takes."""
    ckpt_dir = str(tmp_path / "ckpts")
    state = {"w": np.arange(4, dtype=np.float32)}
    _save_step(ckpt_dir, 2, state)

    sched, backend, pool = make_sched(slices=("s0",))
    sched.add_job("job-a", {"parameters": EIGHT, "checkpoint_dir": ckpt_dir})
    sched.tick()
    assert sched.job("job-a").state == M.RUNNING

    step = sched.preempt("job-a")
    assert step == 2
    job = sched.job("job-a")
    assert job.state == M.PREEMPTED and job.preemptions == 1
    assert "job-a" in backend.deleted
    assert pool.holder_of("s0") is None

    events = sched.tick()  # slice is free again: the job resumes
    assert events[0]["event"] == "resumed"
    assert events[0]["resume_step"] == 2
    assert job.state == M.RUNNING and job.resumes == 1
    assert backend.jobs["job-a"]["env"]["DTX_RESUME_FROM_STEP"] == "2"

    # the restore path the resumed trainer takes hands the state back
    restored, got_step = _restore_step(ckpt_dir, state)
    assert got_step == 2
    np.testing.assert_array_equal(np.asarray(restored["w"]), state["w"])


def test_shrink_preempts_holder_and_leader_evicts_lower_priority(pkg):
    em = M.ExperimentMetrics()
    sched, backend, pool = make_sched(metrics=em, probe=lambda j: None)
    sched.add_job("leader", {"parameters": EIGHT})
    sched.add_job("loser", {"parameters": EIGHT})
    sched.tick()
    sched.set_score("leader", 90.0)
    sched.set_score("loser", 10.0)
    doomed = pool.assignment("leader").name
    displaced = sched.shrink(doomed)
    assert displaced == "leader"
    assert sched.job("leader").state == M.PREEMPTED
    assert pool.size() == 1
    # next tick: the displaced leader outranks the running loser and takes
    # its slice back (score-aware eviction)
    events = sched.tick()
    kinds = [e["event"] for e in events]
    assert "evicted" in kinds and "resumed" in kinds
    assert sched.job("loser").state == M.PREEMPTED
    assert sched.job("leader").state == M.RUNNING
    assert em.registry.counter("dtx_experiment_preemptions_total").get() == 2


def test_eviction_requires_victims_slice_to_fit_contender(pkg):
    """A displaced leader must not evict a job whose slice its mesh can't
    tile — that would burn the victim's checkpoint interval for nothing
    and thrash it every tick."""
    pool = M.SharedSlicePool([M.PoolSlice("small", chips=4)])
    backend = M.FakeTrainingBackend()
    sched = M.SliceScheduler(pool, backend, checkpoint_probe=lambda j: None)
    sched.add_job("loser", {"parameters": {"meshShape": "dp=4"}})
    sched.tick()
    sched.set_score("loser", 10.0)
    # leader needs 8 chips; the only running job holds a 4-chip slice
    sched.add_job("leader", {"parameters": EIGHT})
    sched.set_score("leader", 90.0)
    for _ in range(3):
        events = sched.tick()
        assert all(e["event"] != "evicted" for e in events)
    assert sched.job("loser").state == M.RUNNING
    assert sched.job("loser").preemptions == 0
    assert sched.job("leader").state == M.PENDING


def test_resume_marker_never_leaks_into_later_submissions(pkg):
    """The env copy handed to the backend must not alias job.spec: a
    resume step recorded once must not reappear on a later submission the
    scheduler didn't decide (probe came back None)."""
    steps = iter([7, None])
    sched, backend, _ = make_sched(slices=("s0",),
                                   probe=lambda j: next(steps))
    original_env = {"KEEP": "1"}
    sched.add_job("job-a", {"parameters": EIGHT, "env": original_env})
    sched.tick()
    sched.preempt("job-a")  # probe -> 7
    sched.tick()
    assert backend.jobs["job-a"]["env"]["DTX_RESUME_FROM_STEP"] == "7"
    assert "DTX_RESUME_FROM_STEP" not in original_env  # spec not mutated
    sched.preempt("job-a")  # probe -> None: no step this time
    sched.tick()
    assert "DTX_RESUME_FROM_STEP" not in backend.jobs["job-a"]["env"]
    assert backend.jobs["job-a"]["env"]["KEEP"] == "1"


def test_unscored_job_never_evicts_a_runner(pkg):
    sched, backend, pool = make_sched(slices=("s0",), probe=lambda j: None)
    sched.add_job("runner", {"parameters": EIGHT})
    sched.tick()
    sched.set_score("runner", 5.0)
    sched.add_job("newcomer", {"parameters": EIGHT})
    events = sched.tick()
    assert all(e["event"] != "evicted" for e in events)
    assert sched.job("newcomer").state == M.PENDING


# ---------------------------------------------------------------- watcher
def drive_watcher(feeds, margin=None, min_evals=2):
    """feeds: {job: {step: score}} revealed one step per tick."""
    em = M.ExperimentMetrics()
    sched, backend, _ = make_sched(slices=("s0", "s1", "s2"), metrics=em)
    for name in feeds:
        sched.add_job(name, {"parameters": ANY})
    sched.tick()
    revealed = {n: 0 for n in feeds}

    def checkpoints(job):
        return [s for s in sorted(feeds[job.name]) if s <= revealed[job.name]]

    def score(job, step):
        return feeds[job.name][step]

    w = M.ContinuousScoringWatcher(sched, checkpoints, score,
                                   board=M.Leaderboard(), metrics=em,
                                   early_stop_margin=margin,
                                   min_evals=min_evals)
    return sched, w, em, revealed


def test_watcher_scores_new_checkpoints_into_leaderboard(pkg):
    sched, w, em, revealed = drive_watcher(
        {"a": {1: 50.0, 2: 60.0}, "b": {1: 40.0, 2: 45.0}})
    assert w.tick() == []  # nothing revealed yet
    revealed["a"] = revealed["b"] = 1
    events = w.tick()
    assert {(e["job"], e["step"]) for e in events} == {("a", 1), ("b", 1)}
    assert w.tick() == []  # already scored: no re-scoring
    revealed["a"] = revealed["b"] = 2
    w.tick()
    board = w.board
    assert board.leader().job == "a" and board.leader().score == 60.0
    assert board.entry("b").history == [(1, 40.0), (2, 45.0)]
    assert sched.job("a").score == 60.0  # priorities fed
    assert em.registry.gauge("dtx_experiment_best_score").get() == 60.0
    assert em.registry.counter("dtx_experiment_evals_total").get() == 4


def test_watcher_early_stops_clear_loser_and_frees_slice(pkg):
    sched, w, em, revealed = drive_watcher(
        {"a": {1: 80.0, 2: 85.0}, "b": {1: 20.0, 2: 22.0}},
        margin=30.0, min_evals=2)
    revealed["a"] = revealed["b"] = 1
    assert all(e["event"] != "early_stop" for e in w.tick())  # 1 eval < min
    revealed["a"] = revealed["b"] = 2
    events = w.tick()
    stops = [e for e in events if e["event"] == "early_stop"]
    assert [e["job"] for e in stops] == ["b"]
    assert sched.job("b").state == M.STOPPED
    assert sched.job("b").stop_reason == "early_stop"
    assert sched.pool.assignment("b") is None
    assert em.registry.counter("dtx_experiment_early_stops_total").get() == 1
    # the leader is never early-stopped, scores notwithstanding
    assert sched.job("a").state == M.RUNNING


def test_watcher_retries_unready_endpoint_next_tick(pkg):
    calls = []

    sched, backend, _ = make_sched(slices=("s0",))
    sched.add_job("a", {"parameters": ANY})
    sched.tick()

    def score(job, step):
        calls.append(step)
        return None if len(calls) == 1 else 42.0

    w = M.ContinuousScoringWatcher(sched, lambda j: [1], score)
    assert w.tick() == []  # endpoint not ready: skipped, NOT marked scored
    events = w.tick()
    assert events[0]["score"] == 42.0
    assert calls == [1, 1]


# ------------------------------------------------- scoring-controller bridge
def test_scoring_cr_bridge_drives_existing_controller(pkg):
    """scoring_cr_score creates a Scoring CR and reconciles it through the
    EXISTING ScoringController against a live /chat/completions endpoint —
    the generative-eval path the continuous watcher uses in production."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    ObjectStore = M.mod("operator.store").ObjectStore
    ScoringController = M.mod("scoring.controller").ScoringController

    class Chat(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.dumps({"choices": [{"message": {
                "role": "assistant", "content": "Paris"}}]}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Chat)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}/chat/completions"
        store = ObjectStore()
        score = M.scoring_cr_score(
            store, ScoringController(timeout=5.0), "exp-a-step1", url,
            probes=[{"prompt": "Capital of France?", "reference": "Paris"}])
        assert score == 100.0
    finally:
        srv.shutdown()


def test_poll_interval_resolved_at_construction(pkg, monkeypatch):
    """DTX_EXPERIMENT_POLL_S is read when the controller is BUILT, not at
    import — operators/tests override it without a module reload."""
    FinetuneExperimentController = M.mod(
        "operator.finetuneexperiment_controller").FinetuneExperimentController

    monkeypatch.setenv("DTX_EXPERIMENT_POLL_S", "0.321")
    assert FinetuneExperimentController().poll_s == pytest.approx(0.321)
    monkeypatch.delenv("DTX_EXPERIMENT_POLL_S")
    assert FinetuneExperimentController().poll_s == 5.0
    assert FinetuneExperimentController(poll_s=1.5).poll_s == 1.5


class FakeEngine:
    def __init__(self, name, reply="hello world", dead=False):
        self.name = name
        self.reply = reply
        self.slots = 4
        self._slot_req = [None] * 4
        self.dead = dead
        self.calls = 0

    def chat(self, messages, **kw):
        self.calls += 1
        if self.dead:
            raise RuntimeError(f"{self.name} is dead")
        return self.reply


def _metrics_lint():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                        "metrics_lint.py")
    spec = importlib.util.spec_from_file_location("metrics_lint", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _msg():
    return [{"role": "user", "content": f"q-{uuid.uuid4().hex}"}]


def _pump(gw, n):
    for _ in range(n):
        gw.chat({"messages": _msg()})


# ---------------------------------------------------------------- the loop
def test_closed_loop_e2e(pkg, tmp_path):
    # job-a trains with REAL periodic checkpoints: its preemption must
    # record the step the trainer's restore path will hand back
    ckpt_dir = str(tmp_path / "job-a-ckpts")
    _save_step(ckpt_dir, 3, {"w": np.ones(2, np.float32)})

    em = M.ExperimentMetrics(experiment="e2e")
    backend = M.FakeTrainingBackend()
    pool = M.SharedSlicePool([M.PoolSlice("s0"), M.PoolSlice("s1")])
    sched = M.SliceScheduler(pool, backend, metrics=em)

    feeds = {"job-a": {1: 80.0, 2: 85.0}, "job-b": {1: 20.0, 2: 22.0},
             "job-c": {1: 50.0, 2: 55.0}}
    revealed = {n: 0 for n in feeds}
    watcher = M.ContinuousScoringWatcher(
        sched,
        lambda j: [s for s in sorted(feeds[j.name])
                   if s <= revealed[j.name]],
        lambda j, s: feeds[j.name][s],
        board=M.Leaderboard(), metrics=em,
        early_stop_margin=30.0, min_evals=2)

    fleet = [FakeEngine("fleet-0"), FakeEngine("fleet-1")]
    gw_pool = M.ReplicaPool([M.InProcessReplica(e.name, e) for e in fleet])
    gw = M.Gateway(gw_pool, model_name="e2e")
    serving = M.FakeServingBackend()
    canary_engine = FakeEngine("canary", reply="promoted!")
    runner = M.ExperimentRunner(
        "e2e", sched, watcher, gateway=gw, serving_backend=serving,
        canary_replica_factory=lambda job: M.InProcessReplica(
            "unused", canary_engine),
        promotion_config={"schedule": [0.25, 1.0], "min_requests": 4,
                          "step_s": 60.0},
        metrics=em)

    sched.add_job("job-a", {"parameters": EIGHT,
                            "checkpoint_dir": ckpt_dir})
    sched.add_job("job-b", {"parameters": EIGHT})
    sched.add_job("job-c", {"parameters": EIGHT})

    # ---- tick 1: two slices, first two jobs run, job-c queues
    runner.tick()
    assert {j.name for j in sched.jobs() if j.state == M.RUNNING} \
        == {"job-a", "job-b"}

    # ---- first eval lands for a and b: live leaderboard
    revealed["job-a"] = revealed["job-b"] = 1
    runner.tick()
    assert watcher.board.leader().job == "job-a"

    # ---- pool shrinks under job-a: PREEMPTION with the saved step
    displaced = sched.shrink(pool.assignment("job-a").name)
    assert displaced == "job-a"
    job_a = sched.job("job-a")
    assert job_a.state == M.PREEMPTED and job_a.resume_step == 3

    # ---- next tick: the displaced LEADER evicts the trailing job-b and
    # RESUMES from its checkpoint
    runner.tick()
    assert job_a.state == M.RUNNING and job_a.resumes == 1
    assert backend.jobs["job-a"]["env"]["DTX_RESUME_FROM_STEP"] == "3"
    assert sched.job("job-b").state == M.PREEMPTED

    # ---- pool grows back: job-b resumes beside the leader
    sched.grow(M.PoolSlice("s2"))
    runner.tick()
    assert sched.job("job-b").state == M.RUNNING

    # ---- second evals land: job-b is a clear loser → early-stopped,
    # freeing its slice for job-c
    revealed["job-a"] = revealed["job-b"] = 2
    runner.tick()
    assert sched.job("job-b").state == M.STOPPED
    runner.tick()
    assert sched.job("job-c").state == M.RUNNING
    revealed["job-c"] = 2
    runner.tick()

    # ---- training completes; the winner is the leaderboard leader
    backend.set_state("job-a", "Succeeded")
    backend.set_state("job-c", "Succeeded")
    runner.tick()
    assert runner.phase == M.PHASE_PROMOTE
    assert runner.winner.job == "job-a" and runner.winner.score == 85.0

    # ---- promotion: canary deploys via the serving backend, waits for
    # HEALTHY, then the weighted shift begins
    runner.tick()  # deploys; backend still PENDING
    assert "e2e-canary" in serving.apps
    assert runner.promotion is None
    serving.set_state("e2e-canary", "HEALTHY")
    runner.tick()  # replica in pool + promotion starts
    assert runner.promotion is not None
    runner.tick()  # stage 0 weights applied (canary 25%)
    canary = gw_pool.get("e2e-canary")
    assert canary is not None and canary.weight == pytest.approx(0.25)
    assert all(gw_pool.get(e.name).weight == pytest.approx(0.375)
               for e in fleet)

    # ---- observable shift: smooth WRR gives the canary EXACTLY its share
    _pump(gw, 16)
    assert canary_engine.calls == 4  # 25% of 16
    runner.tick()  # judge stage 0 (clean) → advance to weight 1.0
    assert canary.weight == pytest.approx(1.0)
    assert all(gw_pool.get(e.name).weight == 0.0 for e in fleet)
    before = canary_engine.calls
    _pump(gw, 6)
    assert canary_engine.calls == before + 6  # full rollout: all traffic
    runner.tick()  # judge final stage → COMPLETED
    assert runner.phase == M.PHASE_DONE
    assert runner.promotion.state == "completed"
    assert runner.events[-1]["promoted"] is True

    # ---- promotion phases visible as spans via GET /debug/trace/<id>
    srv = M.serve(gw, port=0, host="127.0.0.1")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = (f"http://127.0.0.1:{srv.server_port}"
               f"/debug/trace/{runner.trace_id}")
        with urllib.request.urlopen(url, timeout=5) as r:
            doc = json.load(r)
        names = [s["name"] for s in doc["spans"]]
        assert "experiment.train" in names
        assert "experiment.promote" in names
        assert "promotion" in names
        assert names.count("promotion.stage") == 2
        stage_weights = sorted(s["attrs"]["weight"] for s in doc["spans"]
                               if s["name"] == "promotion.stage")
        assert stage_weights == [0.25, 1.0]
    finally:
        srv.shutdown()

    # ---- dtx_experiment_* exposition passes the metrics lint, and the
    # gateway exposes the per-replica weight series
    lint = _metrics_lint()
    assert lint.lint_exposition(em.expose(), "experiment") == []
    text = em.expose()
    assert "dtx_experiment_preemptions_total 2" in text  # a, then b evicted
    assert "dtx_experiment_resumes_total 2" in text
    assert "dtx_experiment_early_stops_total 1" in text
    assert 'dtx_experiment_promotion_phase{phase="completed"} 1' in text
    gw_text = gw.metrics_text()
    assert lint.lint_exposition(gw_text, "gateway") == []
    assert ('dtx_gateway_replica_weight{replica="e2e-canary"} 1'
            in gw_text)


# ---------------------------------------------------------------- rollback
def test_promotion_rolls_back_on_canary_regression(pkg):
    fleet = [FakeEngine("fleet-0"), FakeEngine("fleet-1")]
    pool = M.ReplicaPool([M.InProcessReplica(e.name, e) for e in fleet])
    gw = M.Gateway(pool, model_name="rb")
    em = M.ExperimentMetrics(experiment="rb")
    bad = FakeEngine("canary", dead=True)  # every canary attempt errors
    pool.add(M.InProcessReplica("canary", bad))

    promo = gw.start_promotion(
        "canary", config={"schedule": [0.5, 1.0], "min_requests": 3,
                          "step_s": 60.0},
        metrics=em, background=False)
    promo.tick()  # stage 0: canary at 50%
    assert pool.get("canary").weight == pytest.approx(0.5)
    # requests still succeed END-TO-END (failover), but the canary's
    # outcome window fills with errors and its breaker opens
    _pump(gw, 12)
    assert bad.calls >= 3
    state = promo.tick()
    assert state == "rolled_back"
    assert promo.reason
    assert pool.get("canary").weight == 0.0
    assert all(pool.get(e.name).weight == pytest.approx(1.0)
               for e in fleet)
    text = em.expose()
    assert "dtx_experiment_rollbacks_total 1" in text
    assert 'dtx_experiment_promotions_total{outcome="rolled_back"} 1' in text
    assert 'dtx_experiment_promotion_phase{phase="rolled_back"} 1' in text
    # a terminal promotion releases the single-flight slot
    promo2 = gw.start_promotion("canary", config={"schedule": [1.0]},
                                background=False)
    assert promo2 is not promo
    gw.close()


# ------------------------------------------------------------- http surface
@pytest.fixture()
def http_gateway():
    made = []

    def start(engines, **kw):
        pool = M.ReplicaPool([M.InProcessReplica(e.name, e) for e in engines])
        gw = M.Gateway(pool, **kw)
        srv = M.serve(gw, port=0, host="127.0.0.1")
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        made.append((gw, srv))
        return gw, f"http://127.0.0.1:{srv.server_port}"

    yield start
    for gw, srv in made:
        srv.shutdown()
        gw.close()


def _post(url, path, payload):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=10) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_admin_promote_http_contract(pkg, http_gateway):
    fleet = [FakeEngine("fleet-0"), FakeEngine("fleet-1")]
    gw, url = http_gateway(fleet, model_name="m")
    canary_engine = FakeEngine("canary", reply="new model")
    gw.pool.add(M.InProcessReplica("canary", canary_engine))

    code, body = _get(url, "/admin/promote")
    assert code == 404  # nothing started yet
    code, body = _post(url, "/admin/promote", {"replica": "ghost"})
    assert code == 400
    code, body = _post(url, "/admin/promote",
                       {"replica": "canary", "schedule": [0.5, 1.0],
                        "min_requests": 2, "step_s": 30.0})
    assert code == 202
    trace_id = body["trace_id"]
    assert body["canary"] == "canary" and body["schedule"] == [0.5, 1.0]
    code, _ = _post(url, "/admin/promote", {"replica": "canary"})
    assert code == 409  # single flight while active

    # traffic over the HTTP surface drives the stages forward
    deadline = time.monotonic() + 30
    state = ""
    while time.monotonic() < deadline:
        _post(url, "/chat/completions", {"messages": _msg()})
        code, body = _get(url, "/admin/promote")
        state = body["state"]
        if state in ("completed", "rolled_back"):
            break
        time.sleep(0.05)
    assert state == "completed"
    assert canary_engine.calls > 0

    # the whole shift is one trace: root + one span per stage
    code, doc = _get(url, f"/debug/trace/{trace_id}")
    assert code == 200
    names = [s["name"] for s in doc["spans"]]
    assert "promotion" in names and names.count("promotion.stage") == 2

    # weights survived to full rollout and are scrapeable
    with urllib.request.urlopen(url + "/metrics", timeout=5) as r:
        text = r.read().decode()
    assert 'dtx_gateway_replica_weight{replica="canary"} 1' in text
    assert 'dtx_gateway_replica_weight{replica="fleet-0"} 0' in text
    assert "dtx_gateway_replica_attempts_total" in text


def test_promote_schedule_validation(pkg, http_gateway):
    gw, url = http_gateway([FakeEngine("fleet-0"), FakeEngine("x")])
    code, body = _post(url, "/admin/promote",
                       {"replica": "x", "schedule": [0.5, 0.25]})
    assert code == 400 and "schedule" in body["error"]
    code, body = _post(url, "/admin/promote",
                       {"replica": "x", "schedule": [0.5]})
    assert code == 400  # must end at 1.0


def test_single_transient_error_does_not_roll_back(pkg):
    """The error-rate guard waits for min_requests of evidence — one
    transient canary failure (breaker still closed) must not kill the
    promotion."""
    fleet = [FakeEngine("fleet-0"), FakeEngine("fleet-1")]
    pool = M.ReplicaPool([M.InProcessReplica(e.name, e) for e in fleet])
    gw = M.Gateway(pool, model_name="tr")
    flaky = FakeEngine("canary")
    pool.add(M.InProcessReplica("canary", flaky))
    promo = gw.start_promotion(
        "canary", config={"schedule": [0.5, 1.0], "min_requests": 6,
                          "step_s": 60.0}, background=False)
    promo.tick()  # stage 0 at 50%
    flaky.dead = True
    _pump(gw, 2)  # exactly one canary attempt — it fails, failover serves
    flaky.dead = False
    assert promo.tick() == "shifting"  # 1 error, < min_requests: no verdict
    assert promo.stage == 0
    # healthy traffic dilutes the transient: 1 error over 25 canary
    # attempts = 4% < max_error_rate 5% → the stage advances, no rollback
    _pump(gw, 48)
    assert promo.tick() == "shifting" and promo.stage == 1
    _pump(gw, 8)
    assert promo.tick() == "completed"
    gw.close()


def test_replica_added_mid_shift_joins_the_weight_scheme(pkg):
    """The fleet is resolved live: a replica added during the shift is
    folded in at the next weight application and reset on completion —
    it must not keep weight 1.0 while the canary is 'fully rolled out'."""
    fleet = [FakeEngine("fleet-0"), FakeEngine("fleet-1")]
    pool = M.ReplicaPool([M.InProcessReplica(e.name, e) for e in fleet])
    gw = M.Gateway(pool, model_name="grow")
    canary_engine = FakeEngine("canary")
    pool.add(M.InProcessReplica("canary", canary_engine))
    promo = gw.start_promotion(
        "canary", config={"schedule": [0.5, 1.0], "min_requests": 2,
                          "step_s": 60.0}, background=False)
    promo.tick()
    late = FakeEngine("late-joiner")
    pool.add(M.InProcessReplica("late-joiner", late))  # autoscale mid-shift
    _pump(gw, 8)
    promo.tick()  # advance to 1.0: the late joiner must be weighted out
    assert promo.state in ("shifting", "completed")
    _pump(gw, 4)
    while promo.tick() not in ("completed", "rolled_back"):
        _pump(gw, 2)
    assert promo.state == "completed"
    assert pool.get("late-joiner").weight == 0.0
    assert pool.get("canary").weight == pytest.approx(1.0)
    gw.close()


# ------------------------------------------------------------ dtx experiment
def test_cli_fake_backend_runs_whole_loop(pkg, tmp_path, capsys):
    """`dtx experiment -f examples/experiment.json --backend fake` drives
    the entire closed loop in-process: simulated training, leaderboard,
    early stop, canary shift to 100%."""
    dtx_main = M.mod("cli").main

    spec = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "experiment.json")
    status_path = str(tmp_path / "status.json")
    rc = dtx_main(["experiment", "-f", spec, "--backend", "fake",
                   "--tick_s", "0", "--status_json", status_path])
    assert rc == 0
    out = capsys.readouterr().out
    assert '"event": "early_stop"' in out
    assert '"event": "promotion_started"' in out
    status = json.load(open(status_path))
    assert status["phase"] == "done"
    assert status["winner"] == "job-a"
    assert status["promotion"]["state"] == "completed"
    assert status["promotion"]["weight"] == 1.0
    board = {e["job"]: e for e in status["leaderboard"]["standings"]}
    assert board["job-b"]["evals"] >= 2  # loser was continuously scored


# ----------------------------------------------------------- weighted WRR
def test_weighted_routing_shares_are_exact(pkg):
    engines = [FakeEngine("a"), FakeEngine("b"), FakeEngine("c")]
    pool = M.ReplicaPool([M.InProcessReplica(e.name, e) for e in engines])
    gw = M.Gateway(pool, model_name="w")
    gw.set_weight("a", 0.375)
    gw.set_weight("b", 0.375)
    gw.set_weight("c", 0.25)
    _pump(gw, 16)
    assert {e.name: e.calls for e in engines} == {"a": 6, "b": 6, "c": 4}
    # weight 0 receives nothing
    gw.set_weight("c", 0.0)
    for e in engines:
        e.calls = 0
    _pump(gw, 8)
    assert engines[2].calls == 0 and sum(e.calls for e in engines) == 8
    # uniform weights restore the pre-weight least-busy behavior (no WRR)
    gw.set_weight("a", 1.0)
    gw.set_weight("b", 1.0)
    gw.set_weight("c", 1.0)
    _pump(gw, 4)
    assert sum(e.calls for e in engines) == 12


# ------------------------------------------------------- across packages

EXAMPLE = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                       "experiment.json")


def _scripted(pkg_, shrink_at=2, grow_at=5, max_ticks=200):
    """``dtx experiment --backend fake``'s loop, driven tick by tick with a
    pool shrink and a grow: (events, the final status without wall
    times)."""
    M.use(pkg_)
    runner_mod = M.mod("experiment.runner")
    with open(EXAMPLE) as f:
        spec = json.load(f)
    runner = runner_mod._build_fake_experiment(spec)
    sched = runner.scheduler
    for tick in range(max_ticks):
        runner._fake_driver.advance()
        if tick == shrink_at:
            held = sorted(s.name for s in sched.pool.slices()
                          if sched.pool.holder_of(s.name))
            sched.shrink(held[0])
        if tick == grow_at:
            sched.grow(M.PoolSlice("s2"))
        runner.tick()
        if runner.phase == runner_mod.PHASE_DONE:
            break
    status = runner.status()
    for job in status["jobs"]:
        job.pop("runtimeS")
    return runner.events, status


@pytest.mark.parametrize("shrink_at,grow_at", [(None, None), (2, 5)])
def test_the_scripted_loop_makes_the_same_decisions(shrink_at, grow_at):
    """Admissions, scores, the early stop, the winner and the canary shift
    (and with a pool shrink and grow: the preemption and the resume),
    event for event."""
    (ref_events, ref), (port_events, port) = (
        _scripted(p, shrink_at, grow_at) for p in PKGS)
    assert port_events == ref_events
    assert port == ref
    kinds = {e["event"] for e in port_events}
    assert {"started", "winner", "promotion_started",
            "experiment_done"} <= kinds
    if shrink_at is None:
        assert "early_stop" in kinds
    else:
        assert "resumed" in kinds
        assert any(j["preemptions"] for j in port["jobs"])
    assert port["promotion"]["state"] == "completed"


def test_the_port_lists_a_step_once_its_state_pt_exists(tmp_path):
    """The scheduler's resume probe and the local runner's watcher list
    the trainer's checkpoints (``training/checkpoint``): a step directory
    counts once its ``state.pt`` exists."""
    from datatunerx_tpu_torch.experiment import runner, scheduler
    from datatunerx_tpu_torch.experiment.pool import SharedSlicePool
    from datatunerx_tpu_torch.training.checkpoint import (
        checkpoint_probe,
        checkpoint_steps,
        save_raw_state,
    )

    sched = scheduler.SliceScheduler(SharedSlicePool(), None)
    assert sched.checkpoint_probe is checkpoint_probe
    spec = {"name": "e", "pool": {"slices": [{"name": "s0", "chips": 1}]},
            "jobs": []}
    local = runner._build_local_experiment(spec, str(tmp_path / "w"), "cpu")
    assert local.watcher.checkpoints_fn is checkpoint_steps
    ckpt_dir = str(tmp_path / "ckpts")
    job = scheduler.ExperimentJob("a", {"checkpoint_dir": ckpt_dir})
    assert checkpoint_probe(job) is None
    save_raw_state(ckpt_dir, 1, {"w": torch.zeros(1)})
    os.makedirs(os.path.join(ckpt_dir, "2"))  # a step being written
    os.makedirs(os.path.join(ckpt_dir, ".3.tmp-1"))
    assert checkpoint_steps(job) == [1] and checkpoint_probe(job) == 1
    save_raw_state(ckpt_dir, 2, {"w": torch.ones(1)})
    assert checkpoint_steps(job) == [1, 2] and checkpoint_probe(job) == 2
    unset = scheduler.ExperimentJob("b", {})
    assert checkpoint_steps(unset) == [] and checkpoint_probe(unset) is None


def test_experiment_trainers_run_on_device(tmp_path, monkeypatch):
    """The port's ``--device`` (the reference has none): the local
    backend's trainers run on ``cuda`` unless the caller asks for the
    CPU, through ``runner.main`` and ``dtx-torch experiment``."""
    from datatunerx_tpu_torch import cli
    from datatunerx_tpu_torch.experiment import runner
    from datatunerx_tpu_torch.operator import backends

    made = []

    class Recording(backends.LocalProcessBackend):
        def __init__(self, workdir, **kw):
            made.append(kw.get("device"))
            super().__init__(workdir, **kw)

    monkeypatch.setattr(backends, "LocalProcessBackend", Recording)
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"name": "d", "pool": {"slices": [
        {"name": "card0", "chips": 1, "topology": "1x1"}]}, "jobs": []}))
    base = ["-f", str(spec), "--backend", "local", "--workdir",
            str(tmp_path / "w"), "--max_ticks", "1", "--tick_s", "0"]
    assert runner.main(base) == 0
    assert runner.main(base + ["--device", "cpu"]) == 0
    assert made == ["cuda", "cpu"]
    assert cli.main(["experiment"] + base + ["--device", "cpu"]) == 0
    assert made[-1] == "cpu"
    ref_flags = {a.dest for a in _parser(
        "datatunerx_tpu.experiment.runner")._actions}
    assert _parser("datatunerx_tpu_torch.experiment.runner")._actions and \
        "device" not in ref_flags


def _parser(module):
    """The argparse parser ``module.main`` builds (captured, not run)."""
    import argparse

    mod = importlib.import_module(module)
    got = []

    class Stop(Exception):
        pass

    def capture(self, args=None, namespace=None):
        got.append(self)
        raise Stop

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        mod.main(["-f", "x"])
    except Stop:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    return got[0]


def test_chip_smoke_experiment_phase_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s phase 18 at ``preset:debug`` with ``--device
    cpu``: ``dtx-torch experiment --backend local`` trains two 2-step LoRA
    jobs one after the other on a one-slice pool, scores each checkpoint
    at a port server, and leaves no trainer process."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_experiment",
        os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    wall = smoke.experiment_phase(
        torch, str(tmp_path), model="preset:debug", device="cpu",
        flags=("--kv_block_size", "16", "--slots", "2", "--max_seq_len",
               "256", "--device", "cpu"))
    assert wall > 0
