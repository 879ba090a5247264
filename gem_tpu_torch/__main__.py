from gem_tpu_torch.io.cli import main

raise SystemExit(main())
