from .train import main

if __name__ == "__main__":
    from ..utils.distributed import shutdown_distributed

    try:
        main()
    finally:
        shutdown_distributed()
