from repro_torch.models.model import (LM, build_model, params_from_numpy,
                                      params_to_numpy)
