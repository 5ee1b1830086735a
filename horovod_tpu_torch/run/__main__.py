from .run import main

main()
