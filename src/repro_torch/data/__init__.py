from repro_torch.data.ehr import choa_like, movielens_like

__all__ = ["choa_like", "movielens_like"]
