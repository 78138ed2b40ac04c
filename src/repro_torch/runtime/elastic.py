"""Elastic remesh: rebuild the mesh from the live group and reshard.

Port of ``repro.runtime.elastic``. After a failure shrinks the group,
training resumes on the survivors: ``remesh_state`` builds a new
``(data, model)`` mesh over the live ranks, resolves every leaf's
placements from its *logical* spec (the rules table does not depend on
the mesh's shape) and distributes the state across it. With the
deterministic data pipeline and the checkpointed step, a shrink or a
grow is a restart that loses no optimizer state.
"""
from __future__ import annotations

from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.sharding import partition


def remesh_state(state, specs, *, ranks=None, model: int = 0):
    """Reshard ``state`` (a tree of tensors matching ``specs``) onto a
    fresh ``(data, model)`` mesh over ``ranks`` (the group's by default),
    on the state's device type. Every rank passes either its full copy of
    each leaf or the state sharded on another mesh (DTensors), which is
    gathered whole first, with the counted collectives.

    Returns (new_state, new_mesh): the leaves are ``DTensor``s with the
    placements of ``partition.constrained_shardings``.
    """
    whole = partition.gather(state)
    mesh = make_mesh_from_devices(
        ranks, model=model,
        device_type=partition.leaves(whole)[0].device.type)
    placements = partition.constrained_shardings(specs, whole, mesh)
    return partition.distribute(whole, placements, mesh), mesh
