from analytics_zoo_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["tree_leaves", "tree_map"]
