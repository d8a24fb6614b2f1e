"""The loops that drive a traffic mix: ``benchmark/loops/<loop>.py`` each
define ``run(ctx) -> Result``; a traffic file names its loop."""
