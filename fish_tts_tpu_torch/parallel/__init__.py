"""Parallelism: the (dp, tp) device mesh, the sharding rules and the
collectives of the mesh route."""
