"""``Job`` and ``Punchcard`` (local-execution mode; the ssh/scp paths need
a second machine), the reference's four cases run on both packages, plus
the port's script arguments, interpreter and time limit. Exact results:
exit codes, captured output and fetched files."""

import json
import subprocess
import sys

import pytest

from distkeras_tpu import deployment as ref_deployment
from distkeras_tpu_torch import deployment

PACKAGES = {"ref": ref_deployment, "port": deployment}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_job_local_execute(tmp_path, pkg):
    script = tmp_path / "train.py"
    script.write_text("print('hello from job'); open('out.txt','w').write('done')\n")
    job = PACKAGES[pkg].Job("j1", address=None, script_path=str(script),
                            remote_dir=str(tmp_path / "jobs"), fetch=("out.txt",))
    code = job.run(local_artifact_dir=str(tmp_path / "artifacts"))
    assert code == 0 and job.returncode == 0
    assert "hello from job" in job.output
    assert (tmp_path / "artifacts" / "out.txt").read_text() == "done"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_job_failure_code(tmp_path, pkg):
    script = tmp_path / "bad.py"
    script.write_text("raise SystemExit(3)\n")
    job = PACKAGES[pkg].Job("j2", address=None, script_path=str(script),
                            remote_dir=str(tmp_path / "jobs"))
    assert job.run() == 3


def _card(tmp_path, jobs):
    p = tmp_path / "card.json"
    p.write_text(json.dumps({"jobs": jobs}))
    return str(p)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_punchcard(tmp_path, pkg):
    s1 = tmp_path / "a.py"
    s1.write_text("print('a')\n")
    s2 = tmp_path / "b.py"
    s2.write_text("print('b')\n")
    card = _card(tmp_path, [
        {"job_name": "a", "address": None, "script_path": str(s1),
         "remote_dir": str(tmp_path / "jobs")},
        {"job_name": "b", "address": None, "script_path": str(s2),
         "remote_dir": str(tmp_path / "jobs")}])
    pc = PACKAGES[pkg].Punchcard(card)
    assert pc.run() == [0, 0]
    assert [j.output.strip() for j in pc.jobs] == ["a", "b"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_punchcard_stops_on_failure(tmp_path, pkg):
    bad = tmp_path / "bad.py"
    bad.write_text("raise SystemExit(1)\n")
    ok = tmp_path / "ok.py"
    ok.write_text("print('ok')\n")
    card = _card(tmp_path, [
        {"job_name": "bad", "address": None, "script_path": str(bad),
         "remote_dir": str(tmp_path / "jobs")},
        {"job_name": "ok", "address": None, "script_path": str(ok),
         "remote_dir": str(tmp_path / "jobs")}])
    assert PACKAGES[pkg].Punchcard(card).run() == [1]
    assert PACKAGES[pkg].Punchcard(card).run(stop_on_failure=False) == [1, 0]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_punchcard_needs_a_jobs_list(tmp_path, pkg):
    p = tmp_path / "card.json"
    p.write_text(json.dumps({"job": []}))
    with pytest.raises(ValueError, match="'jobs' list"):
        PACKAGES[pkg].Punchcard(str(p))


def test_job_arguments_interpreter_env_and_data(tmp_path):
    """The port's additions: ``args`` reach the script's argv (quoted),
    ``python`` names the interpreter, ``env`` its environment, and a data
    directory is staged beside the script."""
    data = tmp_path / "data"
    data.mkdir()
    (data / "rows.txt").write_text("3\n")
    script = tmp_path / "echo.py"
    script.write_text("import os, sys\n"
                      "print(sys.argv[1:], os.environ['STAGE'],"
                      " open('data/rows.txt').read().strip())\n")
    job = deployment.Job("j3", address=None, script_path=str(script), data_path=str(data),
                         remote_dir=str(tmp_path / "jobs"), args=("--batches", 4, "a b"),
                         python=sys.executable, env={"STAGE": "x y"})
    assert job.run() == 0, job.output
    assert job.output.strip() == "['--batches', '4', 'a b'] x y 3"


def test_job_time_limit(tmp_path):
    script = tmp_path / "slow.py"
    script.write_text("import time; time.sleep(3)\n")
    job = deployment.Job("j4", address=None, script_path=str(script),
                         remote_dir=str(tmp_path / "jobs"), timeout=0.5)
    with pytest.raises(subprocess.TimeoutExpired):
        job.run()


def test_job_without_script():
    with pytest.raises(ValueError, match="no script_path"):
        deployment.Job("j5", address=None).execute()
