from distributed_raytracer.run import main

raise SystemExit(main())
