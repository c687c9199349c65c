"""Distributed runtime of the port: the ``("data", "model")`` layout of
ranks, process-group bring-up and collectives (:mod:`.mesh`), and the
fuser heads split over ``"model"`` (:mod:`.tp`)."""

from .mesh import Mesh, MeshSpec, make_mesh

__all__ = ["Mesh", "MeshSpec", "make_mesh"]
