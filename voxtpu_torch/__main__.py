from voxtpu_torch.cli import main

# Guarded so that importing the module (as a walk over the package does)
# runs nothing.
if __name__ == "__main__":
    raise SystemExit(main())
