"""dp×tp parallelism over torch process groups (counterpart of
``parallel/`` in the JAX package): the mesh, its collectives, tensor-parallel
sharding of the models and mesh-sharded generation."""
