from repro_torch.serve.engine import ServeEngine, Request
