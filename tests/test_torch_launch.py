"""The port's launcher pieces, each on its own and against the JAX package's:

* ``apps.main._worker_specs`` gives the JAX package's worker list (type,
  index, name) for the same async-PPO configuration;
* ``LocalSchedulerClient`` with tiny ``python -c`` workers that complete,
  fail, are killed or ignore SIGTERM (``stop_all`` returns once every
  process has exited);
* ``WorkerControlPanel``'s heartbeat ages, staleness and the terminal
  exemption (the cases of ``tests/system/test_heartbeats.py``), and its
  requests to a live ``WorkerServer``;
* ``base.watchdog.run_bounded``;
* the restart policy: a launch whose model worker fails is launched again,
  every process anew and with ``AREAL_RECOVER=1``; a second failure is
  raised;
* ``SlurmSchedulerClient`` against stubbed ``sbatch``/``squeue``/``sacct``/
  ``scancel`` (the cases of ``tests/scheduler/test_slurm_client.py``), and
  the sbatch script it writes equal to the JAX package's for the same
  inputs.
"""

import os
import signal
import stat
import sys
import time
from pathlib import Path

import pytest
import torch

from areal_tpu_torch.base import constants, name_resolve, names
from areal_tpu_torch.scheduler.client import (
    JobException,
    JobState,
    LocalSchedulerClient,
    make_scheduler,
)
from areal_tpu_torch.system.worker_base import (
    WorkerControlPanel,
    WorkerServerStatus,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- worker specs --------------------------------------------------------


def test_worker_specs_match_the_jax_package(tmp_path, monkeypatch):
    import chip_smoke
    from areal_tpu.apps.main import _worker_specs as jspecs
    from areal_tpu_torch.apps.main import _worker_specs as tspecs
    from tests.test_torch_async_ppo_e2e import _experiment

    monkeypatch.setenv("AREAL_LOG_ROOT", str(tmp_path / "logs"))
    monkeypatch.setenv("AREAL_SAVE_ROOT", str(tmp_path / "save"))
    inputs = chip_smoke.async_inputs(str(tmp_path), 256, rows=8,
                                     words=(2, 6), n_answers=4)
    specs = {}
    for pkg in ("jax", "torch"):
        cfg = _experiment(pkg, *inputs, "specs", n_rollout_workers=2,
                          n_gen_servers=1).initial_setup()
        specs[pkg] = (jspecs if pkg == "jax" else tspecs)(cfg)
    assert specs["torch"] == specs["jax"]
    assert [t for t, _, _ in specs["torch"]] == [
        "master", "model_worker", "gen_server", "gserver_manager",
        "rollout_worker", "rollout_worker"]


# -- the local scheduler ---------------------------------------------------


def _py(code):
    return [sys.executable, "-c", code]


@pytest.mark.parametrize(
    "code,how,want",
    [
        ("print('done')", "wait", JobState.COMPLETED),
        ("import sys; sys.exit(3)", "wait", JobState.FAILED),
        ("import time; time.sleep(60)", "sigkill", JobState.FAILED),
        ("import time; time.sleep(60)", "stop_all", JobState.CANCELLED),
        ("import signal, time; signal.signal(signal.SIGTERM, signal.SIG_IGN)"
         "; print('ready', flush=True); time.sleep(60)", "stop_all",
         JobState.CANCELLED),
    ],
    ids=["completes", "fails", "killed", "stopped", "ignores_sigterm"],
)
def test_local_scheduler(tmp_path, monkeypatch, code, how, want):
    sched = LocalSchedulerClient("e", "t")
    monkeypatch.setattr(LocalSchedulerClient, "STOP_GRACE", 1.0)
    log = tmp_path / "w.log"
    sched.submit("worker", _py(code), log_path=str(log))
    (job,) = sched.find_all()
    assert job.name == "worker/0" and job.pid
    if how == "wait":
        if want == JobState.COMPLETED:
            sched.wait(timeout=30)
        else:
            with pytest.raises(JobException) as e:
                sched.wait(timeout=30)
            assert e.value.reason == JobState.FAILED
    elif how == "sigkill":
        os.kill(job.pid, signal.SIGKILL)
        with pytest.raises(JobException):
            sched.wait(timeout=30)
    else:
        if "ready" in code:
            deadline = time.monotonic() + 30
            while b"ready" not in log.read_bytes():
                assert time.monotonic() < deadline
                time.sleep(0.05)
        sched.stop_all()
    (job,) = sched.find_all()
    assert job.state == want
    # every process has exited when the client says so
    with pytest.raises(ProcessLookupError):
        os.kill(job.pid, 0)
    if how == "wait" and want == JobState.COMPLETED:
        assert log.read_text().strip() == "done"


def test_make_scheduler_refuses_unknown_modes():
    assert isinstance(make_scheduler("local", "e", "t"), LocalSchedulerClient)
    with pytest.raises(ValueError):
        make_scheduler("k8s", "e", "t")


# -- the control panel ---------------------------------------------------

EXPR, TRIAL = "hbtest", "t0"


@pytest.fixture
def panel():
    name_resolve.reconfigure("memory")
    constants.set_experiment_trial_names(EXPR, TRIAL)
    p = WorkerControlPanel(EXPR, TRIAL)
    yield p
    p.close()


def _beat(worker, value):
    name_resolve.add(names.worker_heartbeat(EXPR, TRIAL, worker), str(value),
                     replace=True)


def _status(worker, status):
    name_resolve.add(names.worker_status(EXPR, TRIAL, worker), status.value,
                     replace=True)


def age_tracks_value_changes(panel):
    # a heartbeat with a skewed remote timestamp is fresh when first seen
    _beat("w0", 123456.0)
    assert panel.get_heartbeat_age("w0") == 0.0
    time.sleep(0.05)
    # an unchanged value ages on the observer's clock
    assert 0.04 <= panel.get_heartbeat_age("w0") < 5
    # a changed value resets the age whatever it says
    _beat("w0", 1.0)
    assert panel.get_heartbeat_age("w0") == 0.0


def never_beating_is_not_stale(panel):
    assert panel.get_heartbeat_age("ghost") is None
    assert panel.find_stale_workers(["ghost"], timeout=0.0) == []
    assert panel.get_worker_status("ghost") == WorkerServerStatus.LOST


def terminal_statuses_are_exempt(panel):
    for w in ("alive", "dead", "done", "failed"):
        _beat(w, 1.0)
        panel.get_heartbeat_age(w)  # first observation
    time.sleep(0.1)
    _beat("alive", 2.0)
    _status("done", WorkerServerStatus.COMPLETED)
    _status("failed", WorkerServerStatus.ERROR)
    assert panel.find_stale_workers(["alive", "dead", "done", "failed"],
                                    timeout=0.05) == ["dead"]


@pytest.mark.parametrize(
    "case", [age_tracks_value_changes, never_beating_is_not_stale,
             terminal_statuses_are_exempt], ids=lambda f: f.__name__)
def test_control_panel_heartbeats(panel, case):
    case(panel)


def test_control_panel_requests_a_worker_server(panel):
    """connect, request, group_request and the status key against a live
    ``WorkerServer`` serving its requests from a thread."""
    import threading

    from areal_tpu_torch.system.worker_base import WorkerException, make_server

    server = make_server("w0")
    server.register_handler("echo", lambda x: x * 2)
    server.register_handler("exit", lambda: "exiting")
    silent = make_server("w1")  # registered, never polls its socket
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            server.handle_requests()
            time.sleep(0.005)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        panel.connect(["w0"], timeout=5)
        assert panel.worker_names == ["w0"]
        assert panel.request("w0", "echo", x=21) == 42
        assert panel.group_request("status") == {"w0": "IDLE"}
        server.set_status(WorkerServerStatus.RUNNING)
        assert panel.get_worker_status("w0") == WorkerServerStatus.RUNNING
        with pytest.raises(WorkerException):
            panel.request("w0", "no_such_command")
        assert panel.get_heartbeat_age("w0") == 0.0
        # one request to each at once, one timeout for all: the silent
        # worker is named and its socket dropped
        panel.connect(["w1"], timeout=5)
        tik = time.monotonic()
        assert panel.broadcast(["w1", "w0"], "exit", timeout=0.5) == ["w1"]
        assert time.monotonic() - tik < 2.0
        assert panel.worker_names == ["w0"]
    finally:
        stop.set()
        t.join(5)
        server.close()
        silent.close()


# -- run_bounded ----------------------------------------------------------


def _boom():
    raise RuntimeError("boom")


@pytest.mark.parametrize(
    "fn,status",
    [(lambda: 7, "ok"), (_boom, "error"), (lambda: time.sleep(5), "timeout")],
    ids=["ok", "error", "timeout"],
)
def test_run_bounded(fn, status):
    from areal_tpu.base.watchdog import run_bounded as jrun
    from areal_tpu_torch.base.watchdog import run_bounded

    out = run_bounded(fn, name="section", timeout_s=0.5)
    assert out["status"] == status
    assert out["seconds"] >= 0
    ref = jrun(fn, name="section", timeout_s=0.5)
    assert sorted(out) == sorted(ref)
    if status == "ok":
        assert out["result"] == ref["result"] == 7
    if status == "error":
        assert out["error"] == ref["error"] == "RuntimeError: boom"


# -- the restart policy -----------------------------------------------------


def fail_model_worker(worker_type, worker_index, worker):
    """``AREAL_WORKER_HOOK``: the model worker fails before it runs, in
    the first launch only unless ``FAIL_EVERY_LAUNCH`` is set."""
    recover = os.environ.get("AREAL_RECOVER") == "1"
    with open(os.environ["LAUNCH_RECORD"], "a") as f:
        f.write(f"{worker_type} {int(recover)}\n")
    if worker_type == "model_worker" and (
            not recover or os.environ.get("FAIL_EVERY_LAUNCH")):
        raise RuntimeError("the model worker fails on purpose")


@pytest.mark.parametrize("every_launch", [False, True],
                         ids=["fails_once", "fails_twice"])
def test_restart_policy(tmp_path, monkeypatch, every_launch):
    import chip_smoke
    from areal_tpu_torch.apps.main import launch_experiment
    from tests.test_torch_async_ppo_e2e import _experiment

    record = tmp_path / "launches.txt"
    env = {
        "AREAL_NAME_RESOLVE": "nfs",
        "AREAL_NAME_RESOLVE_ROOT": str(tmp_path / "name_resolve"),
        "AREAL_CACHE_ROOT": str(tmp_path / "cache"),
        "AREAL_LOG_ROOT": str(tmp_path / "logs"),
        "AREAL_SAVE_ROOT": str(tmp_path / "save"),
        "AREAL_WORKER_HOOK": "tests.test_torch_launch:fail_model_worker",
        "LAUNCH_RECORD": str(record),
        "OMP_NUM_THREADS": "1",
        "PYTHONPATH": str(REPO),
        **({"FAIL_EVERY_LAUNCH": "1"} if every_launch else {}),
    }
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    inputs = chip_smoke.async_inputs(str(tmp_path), 256, rows=8,
                                     words=(2, 6), n_answers=4)
    exp = _experiment("torch", *inputs, "restart")
    exp.exp_ctrl.benchmark_steps = 1
    cfg = exp.initial_setup()
    if every_launch:
        with pytest.raises(JobException) as e:
            launch_experiment(cfg, recover_retries=1, timeout=120)
        assert "model_worker" in str(e.value)
    else:
        launch_experiment(cfg, recover_retries=1, timeout=120)
    got = sorted(record.read_text().split("\n")[:-1])
    # every worker of the second launch ran with AREAL_RECOVER=1, and no
    # third launch came
    assert [r for r in got if r.startswith("model_worker")] == [
        "model_worker 0", "model_worker 1"]
    assert [r for r in got if r.startswith("master")][-1] == "master 1"
    if not every_launch:
        # the second launch trained its step
        stats = chip_smoke.read_jsonl(os.path.join(
            constants.get_log_path(), "stats.jsonl"))
        assert [r["step"] for r in stats] == [1]


# -- slurm ----------------------------------------------------------------


@pytest.fixture
def slurm_env(tmp_path, monkeypatch):
    """Fake slurm commands driven by state files the test writes."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    state_file = tmp_path / "state.txt"  # lines: <jobid> <STATE>
    state_file.write_text("")
    cancel_log = tmp_path / "cancelled.txt"

    def script(name, body):
        p = bindir / name
        p.write_text("#!/bin/bash\n" + body)
        p.chmod(p.stat().st_mode | stat.S_IEXEC)

    script("sbatch",
           f'echo "$1" >> {tmp_path}/submitted.txt\n'
           'NEXT=$(( $(cat %s 2>/dev/null | wc -l) + 100 ))\n'
           'echo "Submitted batch job $NEXT"\n' % (tmp_path / "submitted.txt"))
    script("squeue", f"cat {state_file}\n")
    script("sacct", f"cat {tmp_path}/sacct.txt 2>/dev/null || echo COMPLETED\n")
    script("scancel", f'echo "$1" >> {cancel_log}\nexit 0\n')
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    return {"state_file": state_file, "cancel_log": cancel_log,
            "sacct_file": tmp_path / "sacct.txt",
            "script_dir": str(tmp_path / "scripts"), "tmp": tmp_path}


def _slurm(slurm_env, pkg="torch", script_dir=None, **kw):
    if pkg == "jax":
        from areal_tpu.scheduler.client import make_scheduler as make
    else:
        make = make_scheduler
    return make("slurm", "e1", "t1", partition="tpu",
                script_dir=script_dir or slurm_env["script_dir"], **kw)


def submit_writes_an_array_script(c, env):
    c.submit_array("worker", [["echo", "a"], ["echo", "b"], ["echo", "c"]])
    script = open(os.path.join(env["script_dir"], "worker.sbatch")).read()
    assert "#SBATCH --array=0-2" in script
    assert "#SBATCH --partition=tpu" in script
    assert "exec echo a" in script and "exec echo c" in script
    assert c._job_ids["worker"] == "101"


def wait_returns_once_completed(c, env):
    c.submit("worker", ["true"])
    jid = c._job_ids["worker"]
    env["state_file"].write_text(f"{jid} RUNNING\n")
    assert c.find_all()[0].state == JobState.RUNNING
    env["state_file"].write_text("")
    env["sacct_file"].write_text("COMPLETED\n")
    c.wait(timeout=5, poll_interval=0.05)


def wait_raises_on_a_failed_job(c, env):
    c.submit("worker", ["false"])
    env["state_file"].write_text(f"{c._job_ids['worker']} FAILED\n")
    with pytest.raises(JobException) as exc:
        c.wait(timeout=5, poll_interval=0.05)
    assert exc.value.reason == JobState.FAILED


def sacct_failure_after_the_queue(c, env):
    c.submit("worker", ["false"])
    env["state_file"].write_text("")
    env["sacct_file"].write_text("FAILED\n")
    with pytest.raises(JobException):
        c.wait(timeout=5, poll_interval=0.05)


def stop_all_scancels(c, env):
    c.submit("w1", ["sleep", "99"])
    c.submit("w2", ["sleep", "99"])
    c.stop_all()
    assert set(env["cancel_log"].read_text().split()) == set(
        c._job_ids.values())
    assert all(j.state == JobState.CANCELLED for j in c._jobs.values())


def array_states_aggregate(c, env):
    c.submit_array("worker", [["a"], ["b"]])
    jid = c._job_ids["worker"]
    env["state_file"].write_text(f"{jid}_0 RUNNING\n{jid}_1 PENDING\n")
    assert c.find_all()[0].state == JobState.RUNNING
    env["state_file"].write_text(f"{jid}_0 RUNNING\n{jid}_1 FAILED\n")
    assert c.find_all()[0].state == JobState.FAILED


@pytest.mark.parametrize(
    "case", [submit_writes_an_array_script, wait_returns_once_completed,
             wait_raises_on_a_failed_job, sacct_failure_after_the_queue,
             stop_all_scancels, array_states_aggregate],
    ids=lambda f: f.__name__)
def test_slurm_client(slurm_env, case):
    case(_slurm(slurm_env), slurm_env)


@pytest.mark.parametrize(
    "cmds,kw",
    [
        ([["python", "-m", "w", "--x", "a b"]], {}),
        ([["echo", "a"], ["echo", "it's"]],
         dict(log_path="logs/worker.log")),
    ],
    ids=["one", "array"],
)
def test_slurm_script_matches_the_jax_package(slurm_env, cmds, kw):
    tmp = slurm_env["tmp"]
    opts = dict(account="acct", time_limit="01:00:00",
                extra_sbatch_lines=["#SBATCH --gres=gpu:1"],
                env={"AREAL_NAME_RESOLVE": "nfs", "X": "a b"})
    scripts = {}
    for pkg in ("jax", "torch"):
        c = _slurm(slurm_env, pkg, script_dir=str(tmp / pkg), **opts)
        kw_ = dict(kw)
        if "log_path" in kw_:
            kw_["log_path"] = str(tmp / kw_["log_path"])
        c.submit_array("worker", cmds, **kw_)
        scripts[pkg] = (tmp / pkg / "worker.sbatch").read_text()
    assert scripts["torch"] == scripts["jax"]
