from .io import (Counts, Frame, load_counts, load_df_from_npz, load_matrix,
                 save_df_to_npz, save_df_to_text, save_matrix)
from .paths import build_paths

__all__ = ["Counts", "Frame", "build_paths", "load_counts",
           "load_df_from_npz", "load_matrix", "save_df_to_npz",
           "save_df_to_text", "save_matrix"]
