from .manager import CheckpointManager, load_tree, save_tree
