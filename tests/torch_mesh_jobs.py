"""The rank function of the port's family mesh tests
(``test_torch_mesh_moe.py``, ``test_torch_mesh_ssm.py``): a module that
imports the port alone, so a spawned rank does not import jax.

``run_jobs(mesh, jobs)`` runs each ``(kind, args)`` job in turn on this
rank and returns their results in order: ``serve`` is
``serve.sharded.mesh_serve(mesh, *args)``, ``train``
``train.sharded.mesh_train(mesh, *args)`` and ``forward``
``serve.sharded.mesh_forward(mesh, *args)``. One spawn serves, trains
and runs forwards of several models.
"""
from repro_torch.serve.sharded import mesh_forward, mesh_serve
from repro_torch.train.sharded import mesh_train

JOBS = {"serve": mesh_serve, "train": mesh_train, "forward": mesh_forward}


def run_jobs(mesh, jobs):
    return [JOBS[kind](mesh, *args) for kind, args in jobs]
