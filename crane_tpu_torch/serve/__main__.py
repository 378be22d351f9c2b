"""``python -m crane_tpu_torch.serve``: the port's HTTP server (see ``api.main``)."""

from crane_tpu_torch.serve.api import main

if __name__ == "__main__":
    main()
