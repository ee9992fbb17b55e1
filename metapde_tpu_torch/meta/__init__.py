from .maml import MamlDef, maml_inner_step, single_task_rollout as maml_single_task_rollout  # noqa: F401
