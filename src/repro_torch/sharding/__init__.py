from .env import (Mesh, MeshEnv, env_from_mesh, get_env,  # noqa: F401
                  logical_spec, set_env, shard, shard_shape, use_mesh)
