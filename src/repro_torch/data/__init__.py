from repro_torch.data.ehr import choa_like, movielens_like
from repro_torch.data.tokens import TokenStream

__all__ = ["TokenStream", "choa_like", "movielens_like"]
