"""The federation scheduler: multi-job tenancy over one card and one fabric
(the port's copy of ``fedml_tpu/sched``).

Many concurrent federation jobs (different models, populations,
compression policies, round counts) multiplexed over shared
infrastructure:

- ``router``: the job-tagged frame demux; one physical endpoint a rank
  carries every job's traffic, and each job keeps its own reliable-delivery
  streams (``JobRouter``, ``JobChannel``, ``SharedFabric``);
- ``interleave``: share-weighted deficit round-robin over the one device;
  a blocked job yields its slot (``RoundInterleaver``, ``JobDeviceGate``);
- ``jobs``: ``JobSpec``, ``jobs.json`` parsing and the pure spec-to-fixture
  function;
- ``launcher``: ``launch_jobs``, N concurrent federations, each with its
  own control plane under ``<base>/job_<id>/`` and flight logs under
  ``<base>/obs/job_<id>/``;
- ``chaos``: the tenancy failover harness, a real SIGKILL of one tenant's
  server while every other tenant stays bit for bit its solo run
  (``run_tenancy_failover``, ``run_tenancy_smoke``).

CLI: ``python -m fedml_tpu_torch.sched launch --jobs jobs.json [--device
cpu]``.
"""

from fedml_tpu_torch.sched.interleave import JobDeviceGate, RoundInterleaver
from fedml_tpu_torch.sched.jobs import (JobSpec, build_job_fixture,
                                        load_jobs, spec_from_dict)
from fedml_tpu_torch.sched.launcher import (job_control_dir, job_obs_dir,
                                            launch_jobs, run_one_job)
from fedml_tpu_torch.sched.router import (JobChannel, JobRouter,
                                          SharedFabric)

__all__ = [
    "JobChannel", "JobRouter", "SharedFabric",
    "RoundInterleaver", "JobDeviceGate",
    "JobSpec", "load_jobs", "spec_from_dict", "build_job_fixture",
    "launch_jobs", "run_one_job", "job_control_dir", "job_obs_dir",
]
