from repro_torch.models.model import (DecoderOnly, build_model,
                                      params_from_numpy, params_to_numpy)
