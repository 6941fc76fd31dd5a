from pings_tpu_torch.cli import main

main()
